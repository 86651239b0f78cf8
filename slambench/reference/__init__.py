"""The plain reference that decides ``correct`` (:mod:`.plain`)."""
