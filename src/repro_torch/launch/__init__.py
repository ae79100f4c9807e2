"""Command-line tools of the port (``obs_report``)."""
