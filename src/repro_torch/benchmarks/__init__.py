"""The paper's Table 1, Fig. 5 and the quantization-quality table,
measured on the port's device. Run each with
``python -m repro_torch.benchmarks.<name>``; each ``run(csv_rows,
device=None, ...)`` returns its rows."""
