"""Runs over several processes and devices (port of ``v2e2v_tpu/parallel``):
the process group (``distributed.py``) and the data axis of the mesh
(``mesh.py``)."""
