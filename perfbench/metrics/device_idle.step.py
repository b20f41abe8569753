"""Share of a gradient step in which no operation ran on the device, in
%: 1 - the device's busy time a traced step over the device time a step
of the same window's untraced steps (`perfbench.trace.idle_percent`)."""

from perfbench.trace import idle_percent as read

SPANS = []
