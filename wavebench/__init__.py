"""The benchmark of the PyTorch port (``picles_torch``): ensemble
member-days through ``Simulation.run``, held against a plain reference.
Run one cell once with ``python3 wavebench/run.py --workload <cell> --seed
<n> --seconds <s> --trace <0|1>``."""
