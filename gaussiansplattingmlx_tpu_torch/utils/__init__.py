"""Math, SH and camera utilities (torch / numpy; imports nothing eagerly)."""
