"""The port's tools: the run tool (``run``), the GPU bench (``bench``) and
measurement scripts run on the card."""
