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
  * `ops.int8_probe_conv` kernel P1, the int8 conv probe's 3x3 conv on the
                      tensor cores (`csrc/int8_conv3x3.cu`);
  * `ops.quant`       int8 post-training quantization and the mixed forward;
  * `metrics`, `infer` the window/dense `validate_test` serving path;
  * `train`           the training path;
  * `checkpoint`      checkpoints, resume, best tracking, and the importer
                      of dynseg's checkpoints;
  * `export`          the serving artifact: three `torch.export` programs
                      with params and normalization baked in, and
                      `ExportedPredictor`, which loads them onto a device;
  * `serve`           the HTTP server over an artifact
                      (`python -m dynseg_torch.serve`);
  * `cli`, `__main__` `python -m dynseg_torch`, the reference's flags plus
                      `--device`;
  * `probes`          `python -m dynseg_torch.probes.int8_kernel_probe`;
  * `config`, `data`, `sched`, `viz`, `utils.logging`: the port's own
                      copies of the JAX package's host-side numpy modules
                      (with `native/position_tables.cc`), held to the
                      originals by tests/test_torch_data.py.

The package imports torch and numpy, and nothing of the JAX package: it
runs on a machine where `dynseg`, jax, flax and optax are absent.
Kernels are compiled at their first launch, never at import.
"""

__version__ = "0.1.0"
