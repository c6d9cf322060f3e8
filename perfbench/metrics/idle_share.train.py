"""The share of the traced slice in which no kernel, copy or memset ran
on the device."""

from perfbench.trace import idle_share as read  # noqa: F401
