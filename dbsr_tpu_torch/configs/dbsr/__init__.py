"""DBSR training configurations."""
