"""Process-level work sharding (``mesh.py``)."""
