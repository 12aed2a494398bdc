"""Training configurations, ``<module>/<config>.py`` with ``run(settings)``."""
