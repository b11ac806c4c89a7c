"""Multi-device work of the port: `report --distributed N` (dist.py). The
reference's mesh (parallel/mesh.py) waits for `align --mesh` (ROADMAP Queue
1 item 8c)."""
