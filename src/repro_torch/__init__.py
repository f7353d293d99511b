"""repro_torch — the PyTorch/CUDA port of the batch 2-D LP system.

Same sub-package and function names as the JAX package ``repro`` so a
reader finds each counterpart; PyTorch idiom inside (frozen dataclasses
of tensors, plain functions on tensors, explicit ``device=`` and
``generator=`` arguments).  The one accelerator kernel — the RGB
cooperative Seidel solver — is hand-written CUDA C++ for Hopper
(``kernels/csrc/batch_lp.cu``), built at first use.

Entry points run on the card unless the caller asks for the CPU:
:func:`repro_torch.device.default_device` returns ``cuda:0`` or raises.
"""
