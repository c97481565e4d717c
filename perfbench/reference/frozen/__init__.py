"""A frozen copy of the modules of ``boxinstseg_tpu_torch`` (commit
ba3aa5f) that the benchmark's cells run: the registry, ResNet, FPN, the
CondInst and Box2Mask detectors and heads, the MSDeformAttn pixel decoder,
the transformer, the losses, FCOS targets, the Hungarian match, the
batcher, the optimizer groups and schedules, and the ops they call.

Each op keeps only its plain PyTorch version: the registered torch ops,
the CUDA kernels and their flop formulas are cut, and the public entry
(``boxinst_pairwise_loss``, ``ms_deform_attn``, ``lcm_refine``,
``solve_lsa``, ``grid_mst``) runs the plain version, differentiated by
autograd where the port has a hand-written backward. The package
``__init__`` files are empty; ``reference/model.py`` imports what
registers. Docstrings are the port's and may speak of its kernels."""
