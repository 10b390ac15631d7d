"""Route optimization: the greedy VRP and its refiners, candidate
ranking, the road router over a street network, and the GeoJSON
engine, on the device."""
