"""The FL round loop: engine, aggregation, gradient store, planner, server."""
