"""Architecture + shape configs of the LLM scaffold (the port's copies of
the reference's).  ``models.registry.get_config('<arch>')`` resolves the 10
assigned architectures; ``shapes.SHAPES`` the 4 assigned input shapes."""
