"""Share of the traced window with no kernel, copy or memset on the card,
in percent."""
from portbench.harness.readers import idle_percent as read  # noqa: F401
