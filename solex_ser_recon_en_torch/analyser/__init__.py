"""Spectral analyser: atlas-correlation auto-dispersion + GOTO line/shift.

Counterpart of solex_ser_recon_en_tpu/analyser (reference:
spectralAnalyserUI.py, the tool behind the main GUI's "Pixel offset live"
button, UI_handler.py:273-279).  The numeric core is headless
(``SpectralAnalyser``); ``shg-torch-analyse`` (cli/analyse.py) drives it.
``atlas.py`` is a copy of the JAX package's numpy-only module, its data
files (``data/``) copies of the JAX package's.
"""

from .atlas import SolarAtlas, load_lines  # noqa: F401
from .core import SpectralAnalyser, auto_dispersion, goto_shift  # noqa: F401
