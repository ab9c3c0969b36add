"""Host milliseconds of the attribute-side streams' epoch spans
(``attr_view.epoch``, ``ckge_attr.epoch``, ``ckga_attr.epoch``), per driver
epoch.
Moves ``rel_card_ms_per_step``."""
from gpubench.metrics._itc import attr_streams_ms as read  # noqa: F401
