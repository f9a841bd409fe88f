"""Entry points that drive the port's tool kernels on a GPU, and the kernel
timing they share with ``chip_smoke.py``.

    python -m llckbdm_tpu_torch.tools.kernel_smoke [--cpu]
    python -m llckbdm_tpu_torch.tools.bench_eigh_variants
"""
