"""Meshes and the multi-pod dry-run
(``python -m repro_torch.launch.dryrun``)."""
