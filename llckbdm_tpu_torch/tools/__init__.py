"""The port's tools: the entry points that drive its tool kernels, the
measuring tools (counterparts of the JAX package's tools of the same names),
and the kernel timing and bounds they share with ``chip_smoke.py``.

    python -m llckbdm_tpu_torch.tools.kernel_smoke [--cpu]
    python -m llckbdm_tpu_torch.tools.bench_eigh_variants
    python -m llckbdm_tpu_torch.tools.bench_chol
    python -m llckbdm_tpu_torch.tools.ablate_sweep [--cpu]
    python -m llckbdm_tpu_torch.tools.bench_fft_hankel [--cpu]
    python -m llckbdm_tpu_torch.tools.tune_sweeps [--cpu]
    python -m llckbdm_tpu_torch.tools.noise_gate_sweep [--cpu]
    python -m llckbdm_tpu_torch.tools.scaling_bench [--cpu]
"""
