"""Multi-device training, evaluation and serving over ``torch.distributed``."""

from gru4rec_tpu_torch.parallel.mesh import Mesh, factor_mesh, init_distributed, make_mesh

__all__ = ["Mesh", "factor_mesh", "init_distributed", "make_mesh"]
