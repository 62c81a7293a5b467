"""Launch planning on one card: the shape cells and their dry run.

``shapes`` defines the reference's arch × shape cells and their inputs as
``meta`` tensors; ``dryrun`` runs each cell's step on them and reports
FLOPs, bytes by kind, the peak of live bytes, whether the cell fits one
H100 80GB and the largest batch that does, and its roofline terms. Run it
as ``python -m repro_torch.launch.dryrun``.
"""
