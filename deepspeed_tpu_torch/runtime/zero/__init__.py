"""ZeRO of the port: its config (``config.py``) and partition plan
(``partition.py``)."""
