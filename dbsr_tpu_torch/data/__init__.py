"""Training data: on-device burst synthesis and procedural source images."""
