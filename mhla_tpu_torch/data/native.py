"""Random-access reader of webdataset-style ``.tar`` shards (counterpart of
``TarShard`` in ``mhla_tpu/data/native.py``), on the standard library's
``tarfile``: one scan of the headers at open (ustar, GNU long names and PAX
headers, as ``tarfile`` reads them), then one seek and read per member.

Not ported: the ctypes binding over ``native/mhla_data.cc`` (its tar, zip and
document-packing calls) and ``ZipShard``.
"""

from __future__ import annotations

import tarfile
from typing import List, Union


class TarShard:
    """The regular members of a ``.tar`` shard in archive order, read by
    index or by name."""

    def __init__(self, path: str):
        self.path = path
        self._tf = tarfile.open(path, "r")
        self._members = [m for m in self._tf.getmembers() if m.isreg()]
        self._names = [m.name for m in self._members]

    def names(self) -> List[str]:
        return self._names

    def read(self, index_or_name: Union[int, str]) -> bytes:
        if isinstance(index_or_name, str):
            index_or_name = self._names.index(index_or_name)
        return self._tf.extractfile(self._members[index_or_name]).read()

    def close(self) -> None:
        self._tf.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
