"""Multi-device slab decomposition over torch.distributed (`parallel/
domain.py`), its process group (`parallel/multihost.py`) and a launcher
for ranks (`parallel/launch.py`)."""
