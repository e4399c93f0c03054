"""The benchmark of ``simple_spectral_torch`` on NVIDIA H100 cards.

``run.py`` runs one cell once (``harness.py``); ``entries/`` drive the
program's entry points, ``traffic/`` and ``configs/`` hold each cell's
parameters, ``metrics/`` one reader per metric (their shared arithmetic in
``readers.py``), ``yardstick.py`` the frozen peaks, K1's work and the
profiler readers, and ``reference/`` the plain reference that decides
``correct``.  Nothing here imports JAX or the JAX
package; ``reference/`` imports nothing of ``simple_spectral_torch``.
"""
