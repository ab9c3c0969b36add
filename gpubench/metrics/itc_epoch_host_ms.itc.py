"""Host milliseconds of the program's ``itc.epoch`` span (one ITC driver
epoch, train/itc.py ``train_streams_1epo``), per driver epoch.
Moves ``rel_card_ms_per_step``."""
from gpubench.metrics._itc import epoch_ms as read  # noqa: F401
