"""Dataset converter scripts (installed as console commands).

Parity with the reference's six standalone converters (reference
``scripts/``): from extended-xyz, via any ASE-readable format, from
FHI-aims output, from i-PI trajectories, export to extended-xyz, and
extraction of train/valid subsets from a model file.
"""
