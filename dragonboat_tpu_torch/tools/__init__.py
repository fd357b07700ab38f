"""Operator tools (cf. reference tools/: import.go, checkdisk)."""
from .importer import (
    ErrIncompleteSnapshot,
    ErrInvalidMembers,
    ErrPathNotExist,
    import_snapshot,
)
from .checkdisk import check_disk

__all__ = [
    "import_snapshot", "check_disk",
    "ErrIncompleteSnapshot", "ErrInvalidMembers", "ErrPathNotExist",
]
