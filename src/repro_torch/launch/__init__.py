"""Entry points of the port: serving (`serve.py`) and the client mesh of
the sharded engine (`mesh.py`)."""
