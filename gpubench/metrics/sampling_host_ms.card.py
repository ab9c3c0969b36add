"""Host milliseconds of the program's ``rel_view.draw`` spans (sampling.py),
per epoch, from the program's own record of the traced window.
Moves ``rel_card_ms_per_step``."""
from gpubench.metrics._program import sampling_ms as read  # noqa: F401
