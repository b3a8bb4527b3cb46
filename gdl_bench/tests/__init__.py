"""CPU tests of the benchmark (``python -m pytest gdl_bench/tests``); card tests are
marked ``cuda`` and skip without one."""
