"""The SIBR remote-viewer bridge of the port (`network_gui.py`)."""
