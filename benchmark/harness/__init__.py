"""The benchmark harness of the PyTorch/CUDA port (``red_gym_tpu_torch``).

``cli`` reads the arguments and runs a cell; ``manifest`` finds the cell's
files by name; ``sim`` and ``train`` drive the program (the simulator's
step loop, the PPO trainer); ``checks`` holds what the window produced to
the plain reference (``benchmark/reference``); ``trace`` reads the
profiler; ``result`` prints the line.
"""
