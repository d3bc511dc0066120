"""The port's kernels: the two hand-written CUDA policy-scan kernels
(``csrc/policy_scan.cu``, built by ``build.py``, wrapped by
``policy_scan.py``), their plain PyTorch versions (``ref.py``) and the
device dispatch between them (``ops.py``)."""
