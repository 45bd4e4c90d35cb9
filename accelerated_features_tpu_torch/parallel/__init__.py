"""Multi-GPU layer of the port on `torch.distributed`: the (data, model)
mesh (`mesh`), process-group start-up (`distributed`), sharded extraction
and sequence-parallel MNN (`matching`), sequence-parallel LighterGlue
(`lighterglue_sp`), sharded bundle adjustment (`ba`) and a dry run of all
four on spawned gloo ranks (`dryrun`). The sharded train step is
`train.trainer.make_sharded_train_step`."""

from . import distributed
from .mesh import Mesh, make_mesh, replicate, shard_on

__all__ = ["make_mesh", "replicate", "shard_on", "distributed", "Mesh"]
