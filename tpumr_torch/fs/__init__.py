from tpumr_torch.fs.filesystem import FileStatus, FileSystem, Path
from tpumr_torch.fs.inmem import InMemoryFileSystem
from tpumr_torch.fs.local import LocalFileSystem

__all__ = ["FileStatus", "FileSystem", "InMemoryFileSystem",
           "LocalFileSystem", "Path"]
