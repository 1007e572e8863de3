"""Array-API constants. Counterpart of ``cubed_tpu/array_api/constants.py``."""

import numpy as np

e = np.e
inf = np.inf
nan = np.nan
newaxis = None
pi = np.pi
