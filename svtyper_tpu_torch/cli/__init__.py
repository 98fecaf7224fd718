"""Command lines on PyTorch (``classic``: ``svtyper``; ``sso``:
``svtyper-sso``)."""
