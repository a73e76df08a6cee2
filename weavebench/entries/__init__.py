"""The entries: each drives one of the program's paths for a traffic
mix, by the name in the mix's ``entry`` key."""
