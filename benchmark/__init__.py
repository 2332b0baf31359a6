"""The benchmark of the PyTorch/CUDA port (`cvo_slam_tpu_torch`).

One run measures one cell of BENCHMARK.json (a configuration under a
traffic mix): `python3 -m benchmark.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`. See benchmark/run.py.
"""
