"""Model configurations of the port (``base.get_config``)."""
