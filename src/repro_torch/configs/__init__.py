"""Architecture configs of the substrate (counterpart of
``repro.configs``): the dataclasses, the shape sets and the ten arch
modules, copied as pure data."""
from . import base
