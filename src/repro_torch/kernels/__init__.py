"""The port's kernels: the hand-written CUDA sources in ``csrc/`` (the
policy scans, flash attention, the Mamba selective scan and the RWKV-6
WKV recurrence; built by ``build.py``), their wrappers
(``policy_scan.py``, ``flash_attention.py``, ``ssm_scan.py``,
``rwkv6_kernel.py``), their plain PyTorch versions (``ref.py``) and the
device dispatch between them (``ops.py``)."""
