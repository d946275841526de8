"""The benchmark's CPU tests: ``python -m pytest portbench/tests -q`` from
the root of the repository. The ``gpu`` test runs on the card
(``python -m pytest portbench/tests -q -m gpu``) and skips here."""
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]
