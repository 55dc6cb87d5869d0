"""The card the launch plans (``bitrot_cuda.plan``, ``gf_cuda.plan``) are
sized for: an H100 SXM, ``sm_90a``. On another card the kernels stay
correct; only the plans' sizing of waves and shared memory is off."""

SMS = 132                    # streaming multiprocessors
SM_SMEM = 228 * 1024         # shared memory of an SM ...
BLOCK_SMEM_MAX = 227 * 1024  # ... the most one block may take ...
BLOCK_SMEM_RESERVED = 1024   # ... and what the system keeps of it for each block
SM_REGS = 65536              # 32-bit registers of an SM
SM_THREADS = 2048            # resident threads of an SM
SM_BLOCKS = 32               # resident blocks of an SM
