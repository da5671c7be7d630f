"""bfloat16 host arrays without ``ml_dtypes``: the raw bits as ``uint16``,
tagged so that a ``.trims`` header keeps the name ``"bfloat16"`` and the
device put views them as bf16. A file written by either package reads
byte-equal in the other. A leaf module: ``core.store`` and ``device`` both
import it, and it imports neither."""
import numpy as np

BF16_BITS = np.dtype(np.uint16, metadata={"trims": "bfloat16"})
