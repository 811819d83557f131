"""repro_torch: the coupled-STO reservoir simulator and serving engine in
PyTorch, with hand-written CUDA kernels for Hopper (sm_90a).

Beside the JAX package `repro`, which stays the reference, this package
mirrors its module names:

    repro_torch.api       SimSpec x ExecPlan -> compile_plan -> CompiledSim
    repro_torch.core      the paper's coupled-STO reservoir physics
    repro_torch.kernels   CUDA kernels (kernels/csrc), their wrappers and
                          plain PyTorch versions
    repro_torch.serve     the multi-tenant streaming engine and the LM engine
    repro_torch.models    the LM substrate (dense attention family)
    repro_torch.optim, repro_torch.data, repro_torch.train
                          training: optimizers, the synthetic token
                          pipeline, checkpoints, the loop, the watchdog
    repro_torch.launch    command-line entry points (serve, train)
    repro_torch.convert   carry the reference's weights and state across

It imports neither jax nor repro. Entry points take device= ("cuda" by
default) and raise without a card unless the caller passes device="cpu".
"""

__version__ = "0.1.0"
