"""PyTorch/CUDA port of the TargetFuse pipeline for an NVIDIA H100.

Beside the JAX package ``repro``, which stays the reference, with the
same module layout and names. It imports ``torch`` and ``numpy`` and
nothing of JAX or of ``repro``. Its kernels are hand-written CUDA for
``sm_90a`` (``repro_torch.kernels``), each with a plain PyTorch version
that CPU tensors go to. Entry points (``core.mission.Mission``,
``core.pipeline.run_pipeline``, ``launch.serve``) run on ``"cuda"``
unless the caller passes ``device="cpu"``.
"""
