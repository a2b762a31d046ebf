"""The benchmark's yardstick: cell lookup, traffic, drivers, tracing
arithmetic, roofline arithmetic and the check that decides `correct`."""
