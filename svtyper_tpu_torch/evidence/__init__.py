"""Device evidence classification (``device.classify_compact``)."""
