"""Model configurations of the LM substrate: the schema and the
architectures the port runs (``registry``)."""
