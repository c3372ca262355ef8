"""The benchmark of the PyTorch and CUDA port (`pyrodigal_tpu_torch`):
`python3 genebench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`, driven by `BENCHMARK.json` and the files it names."""
