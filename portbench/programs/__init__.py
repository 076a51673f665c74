"""The program side of each architecture: ``<arch>.py`` builds the port's
model of a configuration with the port's own model code, holds every layer
against the reference's layer list and hands in the benchmark's weights."""
