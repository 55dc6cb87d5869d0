"""OfflineDisk — placeholder StorageAPI for an absent/offline drive.

Every call raises DiskNotFound; the quorum layer treats it as a failed
drive (the reference uses nil StorageAPI entries the same way)."""

from __future__ import annotations

from . import errors
from .datatypes import DiskInfo
from .interface import StorageAPI


class OfflineDisk(StorageAPI):
    def __init__(self, endpoint: str = "offline"):
        self.endpoint = endpoint
        self.disk_id = ""

    def disk_info(self) -> DiskInfo:
        return DiskInfo(endpoint=self.endpoint, error="offline")

    def __getattr__(self, name):  # every StorageAPI method fails
        def fail(*a, **kw):
            raise errors.DiskNotFound(self.endpoint)

        return fail

    # abstract methods must exist; route through __getattr__-style failure
    def make_vol(self, *a, **kw):
        raise errors.DiskNotFound(self.endpoint)

    list_vols = stat_vol = delete_vol = make_vol
    write_metadata = update_metadata = read_version = read_versions = make_vol
    delete_version = delete_versions = rename_data = create_file = make_vol
    append_file = read_file = read_file_stream = rename_file = delete = make_vol
    list_dir = stat_info_file = verify_file = make_vol

    def walk_dir(self, volume, base=""):
        raise errors.DiskNotFound(self.endpoint)
        yield  # pragma: no cover
