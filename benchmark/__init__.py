"""The benchmark of the PyTorch/CUDA port (``dbsr_tpu_torch``) on the card:
one command runs one cell of ``BENCHMARK.json`` once (see ``README.md``)."""
