"""Multi-device and multi-process work of the port: `report --distributed
N` and the coordinated `align` world (dist.py), and `align --mesh`'s data x
feature grid of devices (mesh.py)."""
