"""Search front end: grids, splitters, scorers and GridSearchCV."""
