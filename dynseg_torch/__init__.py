"""dynseg_torch — the PyTorch/CUDA port of dynseg for an NVIDIA Hopper card.

`dynseg/` (JAX/Flax/Pallas) stays the reference; every module here keeps
the name of its `dynseg` counterpart so that a reader finds both halves:

  * `bridge`          Flax variables tree <-> this package's state_dict, and
                      SGD momentum buffers <-> optax's trace;
  * `models`          the dilated nets (float32; eval and Flax-exact train
                      BatchNorm, dropout);
  * `ops.int8_conv`   kernel K5, the int8 block conv, as a CUDA kernel
                      (`csrc/int8_block_conv.cu`) beside its plain version;
  * `ops.gather`      kernel K2, the patch gather (`csrc/patch_gather.cu`);
  * `ops.pool`        the stride-1 max-pool and kernel K4, its tie-split
                      backward (`csrc/pool_bwd.cu`);
  * `ops.quant`       int8 post-training quantization and the mixed forward;
  * `metrics`, `infer` the window/dense `validate_test` serving path;
  * `train`, `cli`    the training path and its entry point `run_training`.

The package imports torch and numpy, plus the numpy-only modules of
`dynseg` (config, data.*, sched, viz, ops.dihedral); never jax.
Kernels are compiled at their first launch, never at import.
"""

__version__ = "0.1.0"
