"""The port's model for each of the benchmark's architectures, built
from a configuration file. One module an architecture, found by the
configuration's ``model`` key."""
