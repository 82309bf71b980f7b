"""Multi-GPU rendering over torch.distributed (port of dsrt_tpu/parallel/).

`mesh` joins the ranks and lays them out as an ("sp", "dp") mesh;
`render` renders one frame across it (dp: pixel shards, sp: sample
slices); `dryrun` spawns ranks on one machine and checks the sharded
renders against the single-process ones.
"""
