"""Multi-device training and rendering: view data parallelism over
`torch.distributed` (`dp.py`) and the band-parallel render (`tiles.py`)."""
