"""Host milliseconds of the relation-side streams' epoch spans
(``rel_view.epoch``, ``ckge_rel.epoch``, ``ckgp_rel.epoch``), per driver
epoch.
Moves ``rel_card_ms_per_step``."""
from gpubench.metrics._itc import rel_streams_ms as read  # noqa: F401
