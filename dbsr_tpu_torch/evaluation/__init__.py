"""The SyntheticBurstVal evaluation protocol: network specs, scoring and
the text report."""
