"""The synthetic world and the tile inputs and station arrays made from it."""
