"""Eval experiment specs: each module's ``main()`` returns a list of
``NetworkParam``."""
