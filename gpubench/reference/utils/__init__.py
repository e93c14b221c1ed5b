"""Frozen copies of the port's plain modules (see `gpubench/reference/__init__.py`)."""
