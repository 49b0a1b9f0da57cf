"""Core runtime pieces of the port: the bound dropout generator
(`rng`) and the flat optimizer buckets (`bucketing`)."""
