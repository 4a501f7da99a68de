"""Work sharing across build workers (`coordinator`: the `--coordinate
tcp://HOST:PORT` transport)."""
