"""Device milliseconds launched by the optimizer's applies
(train/sparse_adagrad.py ``dense_apply`` and ``row_apply``), per step of any
stream.
Moves ``rel_card_ms_per_step``."""
from gpubench.metrics._common import apply_ms as read  # noqa: F401
