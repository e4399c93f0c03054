"""CPU tests of the benchmark (``python -m pytest benchmark/tests``); the tests
marked ``gpu`` need a card and skip without one."""
