"""Command-line tools of the port (counterparts of the repo's tools/)."""
