"""Device milliseconds launched by the CNN scorer's forward
(views/attr_conv.py ``conv_score``, inside a benchmark range), per
CNN-scored step.
Moves ``rel_card_ms_per_step``."""
from gpubench.metrics._itc import conv_ms as read  # noqa: F401
