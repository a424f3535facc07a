"""The benchmark of ``mdgen_tpu_torch`` on NVIDIA GPUs: ``python3 -m
portbench.run --workload NAME --seed N --seconds S --trace 0|1`` (see
``run.py``). ``reference/`` holds the plain PyTorch reference that decides
``correct``; it imports nothing of the program."""
