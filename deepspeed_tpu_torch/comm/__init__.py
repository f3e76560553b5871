"""Communication frontend of the port (``comm/comm.py``)."""
