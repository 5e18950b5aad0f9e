"""Multi-shard execution: meshes and their collectives (``mesh``), the
sharding plan of a cell (``sharding``) and pipeline-parallel decode
(``pipeline``). Port of ``repro/distributed`` and ``repro/launch/mesh.py``.
"""
