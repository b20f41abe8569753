"""Share of a frame in which no operation ran on the device, in %: 1 -
the device's busy time a traced frame over the device time a frame of the
same window's untraced frames (`perfbench.trace.idle_percent`)."""

from perfbench.trace import idle_percent as read

SPANS = []
