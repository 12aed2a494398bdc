"""Network modules of the port (channels-last in and out)."""
