"""The port's benchmarks (counterparts of the root ``benchmarks/``):
``run.py`` drives the kernel, flat-bus, Adam and compression suites of
``kernel_bench.py`` and the per-kernel roofline table of
``roofline_report.py``."""
