"""PWC-Net training configs of the port."""
