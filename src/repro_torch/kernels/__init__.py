"""Hand-written Hopper kernels of the port, each beside its plain PyTorch version.

==========================  ==========================================  =====
module                      replaces (TPU kernel)                       route
==========================  ==========================================  =====
`prox_update`               kernels/prox_update.py:91                   CUDA
                            `prox_update_batched`
`logistic_prox`             kernels/logistic_prox.py:64                 CUDA
                            `logistic_prox_gd_batched`
`flash_attention`           kernels/flash_attention.py:105              CUDA
                            `flash_attention`
`decode_attention`          kernels/decode_attention.py:62              CUDA
                            `decode_attention`
==========================  ==========================================  =====

`ops` names the two attention kernels as the model code calls them.

Sources live in `csrc/`; `_build` compiles them with `nvcc` at first use and
binds them with `ctypes`.  Each wrapper runs its plain version for CPU
tensors, launches its kernel for CUDA tensors (or raises) and counts the
launches in its ``.launches`` attribute.  The kernel functions are not
re-exported here, so they cannot shadow their module names.
"""
