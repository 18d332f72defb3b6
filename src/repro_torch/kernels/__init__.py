"""Hand-written Hopper kernels of the port, each beside its plain PyTorch version.

==========================  ==========================================  =====
module                      replaces (TPU kernel)                       route
==========================  ==========================================  =====
`prox_update` (K1)          kernels/prox_update.py:91                   CUDA
                            `prox_update_batched`; its loop form
                            `quadratic_prox_gd_batched` (a whole
                            quadratic solve in one launch)
`logistic_prox` (K2)        kernels/logistic_prox.py:64                 CUDA
                            `logistic_prox_gd_batched` (a row split
                            over a thread-block cluster; the sweep's
                            entry `logistic_prox_gd_indexed` reads the
                            sampled clients' Z and y in place)
`prox_update` (K3)          kernels/prox_update.py:45                   CUDA
                            `prox_update`
`flash_attention` (K4)      kernels/flash_attention.py:105              CUDA
                            `flash_attention` (bf16 at head dim 64 and
                            128: wgmma + TMA, warp-specialised)
`flash_attention` (K4b)     kernels/ops.py:105 `_ca_bwd`, the jnp       CUDA
                            custom_vjp backward (no TPU kernel)
`decode_attention` (K5)     kernels/decode_attention.py:62              CUDA
                            `decode_attention`
`ssm_scan` (K6)             kernels/ssm_scan.py:68 `ssm_scan`           CUDA
`rwkv6_scan` (K7)           kernels/rwkv6_scan.py:58 `rwkv6_scan`       CUDA
`ssm_scan` (K6b)            kernels/_ssm_chunked.py:18, its autodiff    CUDA
                            (no TPU kernel)
`rwkv6_scan` (K7b)          kernels/ref.py:58 `rwkv6_scan`, the         CUDA
                            autodiff of its lax.scan (no TPU kernel)
==========================  ==========================================  =====

`ops` names the kernels as the model and round code calls them: attention
(K4, or K4 and K4b under autograd), decode attention (K5), the Mamba-2 scan
(K6, or K6 and K6b under autograd), the RWKV-6 WKV scan (K7, or K7 and K7b
under autograd) and the tree step (K3, one launch per dtype group).

Sources live in `csrc/`; `_build` compiles them with `nvcc` at first use and
binds them with `ctypes`.  Each wrapper runs its plain version for CPU
tensors, launches its kernel for CUDA tensors (or raises) and counts the
launches in its ``.launches`` attribute.  The kernel functions are not
re-exported here, so they cannot shadow their module names.
"""
