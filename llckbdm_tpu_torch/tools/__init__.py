"""The port's tools: the entry points that drive its tool kernels, the
measuring tools (counterparts of the JAX package's tools of the same names),
and the kernel timing and bounds they share with ``chip_smoke.py``.  The
benchmark's and the tools' entry points, each on the card by default
(``--cpu`` where listed runs the plain versions on the CPU; the fit step
and the multi-rank dry run are ``python -m llckbdm_tpu_torch.entry``):

    python -m llckbdm_tpu_torch.bench [--cpu] [--saturation]
    python -m llckbdm_tpu_torch.tools.kernel_smoke [--cpu]
    python -m llckbdm_tpu_torch.tools.bench_eigh_variants
    python -m llckbdm_tpu_torch.tools.bench_chol
    python -m llckbdm_tpu_torch.tools.ablate_sweep [--cpu]
    python -m llckbdm_tpu_torch.tools.bench_fft_hankel [--cpu]
    python -m llckbdm_tpu_torch.tools.tune_sweeps [--cpu]
    python -m llckbdm_tpu_torch.tools.noise_gate_sweep [--cpu]
    python -m llckbdm_tpu_torch.tools.scaling_bench [--cpu]
    python -m llckbdm_tpu_torch.tools.precision_gate [--cpu]
    python -m llckbdm_tpu_torch.tools.config5_run [--cpu]
    python -m llckbdm_tpu_torch.tools.trace_capture [--cpu]
    python -m llckbdm_tpu_torch.tools.profile_stages [--cpu] [--out FILE]
"""
