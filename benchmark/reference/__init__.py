"""The benchmark's yardstick on the host: the frozen float64 oracle, the
frozen signal generators and the comparison that decides ``correct``.
numpy and scipy only; nothing here imports the program."""
