"""dynseg_torch — the PyTorch/CUDA port of dynseg for an NVIDIA Hopper card.

`dynseg/` (JAX/Flax/Pallas) stays the reference; every module here keeps
the name of its `dynseg` counterpart so that a reader finds both halves:

  * `bridge`          Flax variables tree <-> this package's state_dict;
  * `models`          the dilated nets (eval semantics, float32);
  * `ops.int8_conv`   kernel K5, the int8 block conv, as a CUDA kernel
                      (`csrc/int8_block_conv.cu`) beside its plain version;
  * `ops.quant`       int8 post-training quantization and the mixed forward;
  * `metrics`, `infer` the window/dense `validate_test` serving path.

The package imports torch and numpy, plus the numpy-only modules of
`dynseg` (config, data.tiles, data.datasets, ops.dihedral); never jax.
Kernels are compiled at their first launch, never at import.
"""

__version__ = "0.1.0"
