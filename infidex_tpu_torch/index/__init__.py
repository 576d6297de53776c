"""Port overlay of ``infidex_tpu.index``: the port's own modules here win;
every other module of the subpackage is the reference's file, loaded
under this package's name (see ``infidex_tpu_torch/__init__.py``)."""

from ..runtime import reference_dir as _reference_dir

__path__.append(_reference_dir("index"))
