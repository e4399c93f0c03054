"""The benchmark's plain reference of the renderer.

A frozen copy of the renderer's plain path, renamed into the benchmark: the
threefry streams (``rng``), the colour tables (``colorimetry``,
``spectrum``, ``upsample_jakob``), the scene library (``scene_library``,
``scene_types``, ``image``), the closest-hit sweep over a ``[T, N]`` grid
(``intersect``, the plain twin of kernel K1), the integrator with its
shading and sampling, and the steps that the benchmark's cells time
(``steps``).  It imports nothing of the package under test: it reads the
same data files and rebuilds every table, texel word and triangle from them.
It runs on the card in float32 with TF32 off; ``trace_lanes``'s
``shade_dtype`` puts its shading into bfloat16 for the control.
"""
