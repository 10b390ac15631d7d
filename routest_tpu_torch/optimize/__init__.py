"""Route optimization: the greedy VRP and its refiners, candidate
ranking and the GeoJSON engine, on the device."""
