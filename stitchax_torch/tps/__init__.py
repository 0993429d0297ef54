"""TPS breaking: border control points, TPS solve + dense map (K2), mix."""
