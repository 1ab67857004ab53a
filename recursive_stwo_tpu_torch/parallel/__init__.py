"""Multi-device verification on torch.distributed: the SPMD launcher
(launch.py), the sharded verifiers (mesh.py, twin of
recursive_stwo_tpu/parallel/mesh.py) and the multi-device dry run
(dryrun.py, twin of __graft_entry__.py::dryrun_multichip)."""
