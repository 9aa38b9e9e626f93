"""The bench tests run on the CPU at tiny sizes; the root and ``src`` are
put on the path, as ``bench/run.py`` puts them."""
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
