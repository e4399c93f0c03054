"""The program's entry points that cells drive, one module per ``entry`` of
a traffic file: set-up, the measured window, the traced window and the
check against the reference."""
