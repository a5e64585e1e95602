"""Aileron Regular as PIL draws it for `ImageFont.load_default(size)`
(Pillow 12.1.0, FreeType 2.14.1), sizes 8 to 16.

Written by scripts/make_font_table.py, which checks it against PIL
before writing; do not edit. GLYPHS[size] = (base64 of the zlib'd
coverage maps, one row per printable ASCII character: (code, dx, dy,
width, height, advance, *getbbox)). `eval/glyphs.BitmapFont` reads it.
"""

GLYPHS = {
    8: (
        "eNpdVOlXU0cU/yV5hE2QCDlV0BZRCojbUUERPULLjiBUwQ8QK5sJ6AGsVEABQ3hIgLBkIyzBKCLgcgqULaKEAaRV"
        "RA2nLe2xp4rtt37ol/4DnRfAovPevTN35m5z595LQOjXgMxkQkwmuGcVQ9yubnVAcbIvdvXfT4OgqASAz+sEPkae"
        "SjQYmucD2/6ypNilE7tp9LyrTwHOAp2lRudR0bnSHFMQ5T8/VhOHoFuzvCciswurUqS3VPrAwkcW4p7V/Xl6woFa"
        "LWmsMIOYEBaePuAygxm+YodLWRgk4S4DlJgJrCx3ETCE4bvmL+W7Itczl+ol1BXZa5mPbQUkUigQenQiMaN6Fw7G"
        "oEwgLEXyHsiBY0CYsfPYiKPjiAWwcDOlw7a0W31FxCbP/SF6zaVce94MUJbCr01Ct5m9GN9mKD0NBzMCnp05D+bx"
        "Zb1GQvX9DrhrqYzenSD4pnwpzuZPo5JNvV3R5H/VWTSWA8H4NwZduF+1usRU3Hzwhdt687BAMB7T1hr5LXv9ZyAv"
        "Hu63Ac3n2KekUWppKzALmOH0UZL2iGEmCgyqvEydOpowzHBY45UZvZ3H3diOVn96NzooXl7QUWEvNgIO2RmFGy+e"
        "c4b4sq9MJuMgxx5eRVlOmYWXxBD3aMv9dgkmAPYInE9T6zGAb35eFj/ogbK8uHx8+BO998TkNEZd+mu6ioqvfMbk"
        "FmbsAZyengK+DlQDXfIxz8BsbC9RbwaGrFW6CgKB2Sp/fIHOP1qrmqUeWrk2+YYvoLBwjvVuA4/dYlJoIqxV1QZP"
        "Gi7vXu6pLBT5Ga3sdY27lWWl3JZVLo+yzSx7cc3eEbL8zhA1X6urhDEASHGlusv6NnZTM/PenkaFut/bxmVDC0ql"
        "cuF/0jZWVNhAD96stMmYTyC+LSabujZg/id/YM7/oRtl2Dfm+AH3ikO/XQfkv5IBPq+bkLzoMCkhbp16V6q5TQ+y"
        "2M4ZUn1JkdO4E90Mr+dsGha9Oyo7vPs84dnHRcPS5wWvvq1GhdF7oUZfRMD/YUHZErlqhzK3f8ox3+GYJznmO1uN"
        "NYuplGK2Wqv05QTMtFVOjhFsb6QSI5DWdSVhUiRMQUBD5yHhGTgQVGvVOQXsO7ZgpSg+QGQ5LDZ4woBIDIa05t3A"
        "GG93HUKuAoN83SaaicdvchH/g+Z07xZ8dw1JMkmGg+EedF4eXbEnDRt6gf4Gl6SSMqD8Adb9vQfxpYiQo/bELT5c"
        "/6UatUfuC6VpCNUooumBcEw8KMThNyFrfJGyyiW6Uh2mDeMcENxEiTe1LCvUxRGsfrqECqDIGT605GgVZ23G+r1x"
        "uvfHJEGHvQ9otgXFbZOh5qhMdvRUcIyxrvpAnGT+bojomaqh2pYMzyuNSa/4zOQLHjP+UmWICFXrpGYGCRYGocfb"
        "dWc4lyJaVC/HGf6LSYHA+lWH4nlwJVsHc0lJr9uUA+S8qI562nMOZGJa6P9WshpNrJXS3lA8TWvTZHIW5xpMFYuO"
        "mJ1aCXfCAbx3G6k71zwIfWxEdi/nG78lfKo5BL+YUkF4nfGrAubdL9meavVzvOKUkRU0p2r9wES0oTXyEWP36DGF"
        "2Na26I8vzVn4+JKc0fkmEW3jy67AUKPE0Ikd9n5Rg4Keai3dO/Q2eeXw++SV5JmahcPitRt1c6NCDPKyk/cXwflW"
        "rQeg1tDbCC7cQ5dHWaiu1akHvvWqtMoMYDZJ/I8IbXuzJc4DKrj2tcPkk50z5Cx4yEvMTswEr7vTHigsBWJ71gEy"
        "+VwWvmjDznt2WGqURyE3AB2AGftVHAYtudzAs8vlTfzCaTcDBmiHWsfhXASEY2NZwMkw99S8/wDyS07E"
        ,
        [
            (32, 0, 0, 0, 0, 2, 0, 8, 2, 8), (33, 0, 3, 2, 5, 1, 0, 3, 2, 8), (34, 1, 3, 2, 2, 3, 0, 3, 3, 8), (35, 0, 3, 5, 5, 5, 0, 3, 5, 8),
            (36, -1, 2, 5, 7, 4, -1, 2, 4, 9), (37, 0, 3, 6, 5, 6, 0, 3, 6, 8), (38, 0, 3, 5, 5, 5, 0, 3, 5, 8), (39, 0, 3, 1, 2, 1, 0, 3, 1, 8),
            (40, 1, 2, 2, 7, 3, 0, 2, 3, 9), (41, 0, 2, 2, 7, 3, 0, 2, 3, 9), (42, 0, 5, 5, 3, 5, 0, 5, 5, 8), (43, 0, 4, 5, 4, 5, 0, 4, 5, 8),
            (44, -1, 7, 3, 2, 2, -1, 7, 2, 9), (45, 0, 5, 2, 1, 2, 0, 5, 2, 8), (46, 0, 7, 2, 1, 2, 0, 7, 2, 8), (47, 0, 3, 3, 6, 2, -1, 3, 3, 9),
            (48, 0, 3, 4, 5, 5, 0, 3, 5, 8), (49, 0, 3, 3, 5, 5, 0, 3, 5, 8), (50, 0, 3, 4, 5, 5, 0, 3, 5, 8), (51, 0, 3, 4, 5, 5, -1, 3, 5, 8),
            (52, 0, 3, 5, 5, 5, 0, 3, 5, 8), (53, 0, 3, 4, 5, 5, 0, 3, 5, 8), (54, 0, 3, 4, 5, 5, 0, 3, 5, 8), (55, 0, 3, 4, 5, 5, 0, 3, 5, 8),
            (56, 0, 3, 4, 5, 5, 0, 3, 5, 8), (57, 0, 3, 4, 5, 5, 0, 3, 5, 8), (58, 0, 4, 2, 4, 2, 0, 4, 2, 8), (59, -1, 4, 3, 5, 2, -1, 4, 2, 9),
            (60, 1, 4, 3, 4, 5, 0, 4, 5, 8), (61, 0, 5, 4, 2, 5, 0, 5, 5, 8), (62, 1, 4, 3, 4, 5, 0, 4, 5, 8), (63, 0, 3, 4, 5, 4, 0, 3, 4, 8),
            (64, 0, 3, 6, 6, 6, 0, 3, 6, 9), (65, 0, 3, 5, 5, 5, 0, 3, 6, 8), (66, 1, 3, 4, 5, 5, 0, 3, 5, 8), (67, 0, 3, 5, 5, 5, 0, 3, 5, 8),
            (68, 1, 3, 5, 5, 6, 0, 3, 6, 8), (69, 1, 3, 4, 5, 5, 0, 3, 5, 8), (70, 1, 3, 4, 5, 5, 0, 3, 5, 8), (71, 0, 3, 6, 5, 6, 0, 3, 6, 8),
            (72, 1, 3, 5, 5, 7, 0, 3, 7, 8), (73, 1, 3, 1, 5, 3, 0, 3, 3, 8), (74, 0, 3, 4, 5, 4, 0, 3, 4, 8), (75, 1, 3, 5, 5, 5, 0, 3, 6, 8),
            (76, 1, 3, 4, 5, 5, 0, 3, 5, 8), (77, 1, 3, 6, 5, 8, 0, 3, 8, 8), (78, 1, 3, 5, 5, 7, 0, 3, 7, 8), (79, 0, 3, 5, 5, 5, 0, 3, 5, 8),
            (80, 1, 3, 4, 5, 5, 0, 3, 5, 8), (81, 0, 3, 5, 6, 5, 0, 3, 5, 9), (82, 1, 3, 4, 5, 5, 0, 3, 5, 8), (83, 0, 3, 5, 5, 5, 0, 3, 5, 8),
            (84, 0, 3, 5, 5, 5, 0, 3, 5, 8), (85, 1, 3, 4, 5, 5, 0, 3, 5, 8), (86, 0, 3, 6, 5, 5, 0, 3, 6, 8), (87, 0, 3, 8, 5, 8, 0, 3, 8, 8),
            (88, 0, 3, 5, 5, 5, 0, 3, 5, 8), (89, 0, 3, 5, 5, 5, 0, 3, 5, 8), (90, 1, 3, 5, 5, 6, 0, 3, 6, 8), (91, 1, 2, 2, 7, 3, 0, 2, 3, 9),
            (92, 0, 3, 3, 6, 2, -1, 3, 3, 9), (93, 0, 2, 2, 7, 3, 0, 2, 3, 9), (94, 0, 3, 4, 3, 5, 0, 3, 5, 8), (95, 0, 8, 4, 1, 4, 0, 8, 4, 9),
            (96, 0, 3, 2, 1, 2, 0, 3, 2, 8), (97, 0, 4, 4, 4, 5, 0, 4, 5, 8), (98, 0, 3, 4, 5, 4, 0, 3, 4, 8), (99, 0, 4, 4, 4, 4, 0, 4, 4, 8),
            (100, 0, 3, 4, 5, 5, 0, 3, 5, 8), (101, 0, 4, 5, 4, 5, 0, 4, 5, 8), (102, -1, 2, 3, 6, 2, -1, 2, 2, 8), (103, 0, 4, 4, 5, 5, 0, 4, 5, 9),
            (104, 0, 3, 4, 5, 4, 0, 3, 4, 8), (105, 0, 2, 2, 6, 2, 0, 2, 2, 8), (106, -1, 2, 3, 7, 2, -1, 2, 2, 9), (107, 0, 3, 4, 5, 4, 0, 3, 4, 8),
            (108, 0, 3, 2, 5, 2, 0, 3, 2, 8), (109, 0, 4, 5, 4, 5, 0, 4, 5, 8), (110, 0, 4, 4, 4, 4, 0, 4, 4, 8), (111, 0, 4, 4, 4, 4, 0, 4, 4, 8),
            (112, 0, 4, 4, 5, 4, 0, 4, 4, 9), (113, 0, 4, 4, 5, 5, 0, 4, 5, 9), (114, 0, 4, 3, 4, 2, 0, 4, 3, 8), (115, 0, 4, 4, 4, 5, 0, 4, 5, 8),
            (116, 0, 3, 3, 5, 3, 0, 3, 3, 8), (117, 0, 4, 4, 4, 5, 0, 4, 5, 8), (118, 0, 4, 5, 4, 4, 0, 4, 5, 8), (119, 0, 4, 7, 4, 6, 0, 4, 7, 8),
            (120, 0, 4, 4, 4, 4, -1, 4, 4, 8), (121, 0, 4, 5, 5, 4, 0, 4, 5, 9), (122, 1, 4, 4, 4, 5, 0, 4, 5, 8), (123, 0, 2, 3, 7, 3, 0, 2, 3, 9),
            (124, 1, 1, 1, 8, 3, 0, 1, 3, 9), (125, 0, 2, 3, 7, 3, 0, 2, 3, 9), (126, 0, 5, 4, 2, 5, 0, 5, 5, 8),
        ],
    ),
    9: (
        "eNp9VmtQFFcW/uYFAwMSHoJmlYcj8kosNw+FhVUWBU2iIUGMkSBiIhtKiAYElGhcDCDCwGAwkAFGmEfPQ4ZRhhlg"
        "xBCNiTHGWgkI2Ayy1rqYpWSrzCabrdqt/bGnW1yIlezt6a/73Hv69HfPPffrAQv+kGh3VrPUEhOBimIfr/ruy5uR"
        "troMqwZaOiNRtTMCqDwmBLV8YEXLD2m4soh14NomFpDr/r2HBlxfeN2SssPIGfzxOO9Xa6oROf1dkvGiTGS0HTrH"
        "PW090vY6MkpcbuO+/WKlufZtR5scw27Yj41/7vi+/LKc2IxJCbIc2qsgQtLG3K39fqMYRb9f7lZpY6M0Pde/n8xR"
        "//PpuY1SkC+ePfTtodV4S5EDpNHB9/GQUva3spRZM45ON59r2TlZFYFektoMiKuwYROqJEIFfvsqKj1QD4TZdLaw"
        "jljEmUfJfZSDEd7kB0IMd7MjWD7eo1+p8XyW3ALpLfJM0ALxVhm2MO5I/tHINKCuoy/fLwO+LmDn/SxPdywxbDsC"
        "75tixmB7AVh/H1hgo8HmX7PYfITCOSzm70sech9hmH1+VzVM6Kp2QZzDUwaMJTViqVPQarBGeNe0dO6vrtF+HPLN"
        "BiRZuAmO9UYh2h7dq7WGJTLMmbvUtW8X4DNAy1ZDSQjpph79KqC4x54zLPVgX7s9kXs9KIgZkkpHt/c4sp6ztluj"
        "vvbFwq4vVyDmTnh7e8l1VRDWKxL62pq8FTu83QA+cYod4O65Jvsjtr+LJzjryXi/o8cCboQBEQ3vuAPPvLC8rKws"
        "kXcLr6ioSEoXAC+riYmgPD+mPkdc6AGkd3XnqSUiyvO2ckSahJBHAi+qAXF+w8ktkNnWQdSy/YMdyw1V674c9HBG"
        "vhEwegsuYdEy20BwrqL0w+CUsx5Ykg6s/eh4EeUIJitBgM6yENi/6fU84Au98RKebgTM8tokYOvRKX13CSXYcxJT"
        "mgt7uFT7vEPgPTLFaHs2uyl0xlOiY28Dpbu/EQMi6U0RoUS5G6h61UttMBzHlN6s86VH0tQEglEC4RBBpmKKsag8"
        "pxiGCeZLbkqjOfW/WiSTBlb+ZLRi3igPosNaXd9TpQXAmqFBCZfVYQl2aS9W53HV4tFg1J5gOceHcM9sNt+bMx8C"
        "32bj8WcwnSNiNzar2/4WdRzOZ1FYBHbv+8B0zynOqfldAvGF1MfIPMZ8mrZ1+TR7FmBYVikPrmTZtYX5a1hWeKZd"
        "QK9s/BDsdCNHwRxGEN3OMdJEEywzcYyapmVNen2TrC4LyKod5rI6xOd2WMn1KL2a9fpmL5rTpynk7XuTIOorbopR"
        "c0Qogu4jTz5CNR9hkI8wzkeo9VLpnf98jfd7hijbS7hlHbxntvx1Bd3tLeQiGgjcbmCXrTcZYwKfBpwwJlNhLq1S"
        "+50GFeLhs30ZAQzzd4YJevTS/3N5PPkc3AjEoutrezU9CYoXgS3lK0kWjOH43F3WDxxMzSCVWsJYfMjVrgN08dj4"
        "L28UZGS+h1rNZnQFBDphX3VSdB74/FcqwSdrjtL+PfUKmJPPUw384I1dd4VIVgFdK9GwMY8Kw+OikYL5Ou20001P"
        "Z/8Be4sAQ6LwcggWfSbCmnPQcOLXWt7K0Q54EPD4LA4zzM1CYuV0h6RnGaBMpdquoYEHZobJ7Nw3+5Xgj84CJTix"
        "JMkk4ST55ERUXLWvc54PW9AJ/J7KN6qe1kUhq0dgJdJSNpEKuP0uI77PVvpmqHAsTV39F1Yiu1flUE/OrbDr47ae"
        "qJlwPNV/m1PgmRBEd02a286EhHdoVMLeUByIGeP8PgtF8dLn+7R1c5NhQ0ynTZO2SITOcC6TFyKxfCamp61pIsyk"
        "1km7Q5GfO6FSGQsuBOClxJWWNrMPGrvo2Q3f1c3XdArT4fqZMK4jC/Hklbhudfezj9bepXIemJF7Ttx5uPj8uSWX"
        "H5w9dmTOtzB+pHX+3ko1CtlYiwR3v40C7sR+5cP1OcXzE341/bb6/HvtF0vuB0r/ESgdnwAmZt80d3GpBoiHx094"
        "yK2nz8od0Yh2cNMY64lBTE/4ubau5b+Y4jlmv5jJOe4Tutj7i+fShhLLJ6m4tdgvG3FWW5z4IAJH8L7dwknttu+O"
        "znrRt85Zxs6RvOPykM8UX2p1XV2AvTkH3oDjicVWPxNtjf0v047+kwRD3gv/IxdeP/FSumHPauVv6hoidKXrhP0m"
        "2DtEON1AewbGBN9LUv+BludIn+wkmbbmBHTF+F7xpHQW7qag/QsWdwQZAFshbchsF6l6bC2Q2h8IfKAZLIL/JRlM"
        "q5FNivhAr9mGgxvQAXyNGAuiSe6ugTNLktlHLUkpwKdeGKb/M/GwxGEIZK5XCooqffPy/auK/wuYpDuS"
        ,
        [
            (32, 0, 0, 0, 0, 2, 0, 9, 2, 9), (33, 0, 3, 2, 6, 3, 0, 3, 3, 9), (34, 1, 2, 2, 3, 3, 0, 2, 3, 9), (35, 0, 3, 5, 6, 5, 0, 3, 5, 9),
            (36, 0, 1, 5, 9, 5, 0, 1, 5, 10), (37, 0, 3, 6, 6, 6, 0, 3, 6, 9), (38, 0, 3, 5, 6, 5, 0, 3, 5, 9), (39, 0, 2, 1, 3, 1, 0, 2, 1, 9),
            (40, 1, 2, 2, 8, 3, 0, 2, 3, 10), (41, 0, 2, 2, 8, 3, 0, 2, 3, 10), (42, 0, 5, 5, 4, 5, 0, 5, 5, 9), (43, 0, 4, 5, 5, 5, 0, 4, 5, 9),
            (44, -1, 7, 2, 3, 2, -1, 7, 2, 10), (45, 0, 6, 3, 1, 2, 0, 6, 3, 9), (46, 0, 7, 2, 2, 2, 0, 7, 2, 9), (47, 0, 2, 3, 7, 3, -1, 2, 3, 9),
            (48, 0, 3, 5, 6, 5, 0, 3, 5, 9), (49, 1, 3, 3, 6, 5, 0, 3, 5, 9), (50, 0, 3, 5, 6, 5, 0, 3, 5, 9), (51, 0, 3, 5, 6, 5, 0, 3, 5, 9),
            (52, 0, 3, 5, 6, 5, 0, 3, 5, 9), (53, 0, 3, 5, 6, 5, 0, 3, 5, 9), (54, 0, 3, 5, 6, 5, 0, 3, 5, 9), (55, 0, 3, 5, 6, 5, 0, 3, 5, 9),
            (56, 0, 3, 4, 6, 5, 0, 3, 5, 9), (57, 0, 3, 5, 6, 5, 0, 3, 5, 9), (58, 0, 4, 2, 5, 2, 0, 4, 2, 9), (59, -1, 4, 3, 7, 2, -1, 4, 2, 11),
            (60, 1, 4, 4, 5, 5, 0, 4, 5, 9), (61, 0, 5, 5, 3, 5, 0, 5, 5, 9), (62, 1, 4, 4, 5, 6, 0, 4, 6, 9), (63, 0, 3, 4, 6, 4, 0, 3, 4, 9),
            (64, 0, 2, 7, 8, 7, 0, 2, 7, 10), (65, 0, 3, 6, 6, 6, 0, 3, 6, 9), (66, 1, 3, 5, 6, 6, 0, 3, 6, 9), (67, 0, 3, 6, 6, 6, 0, 3, 6, 9),
            (68, 1, 3, 5, 6, 6, 0, 3, 6, 9), (69, 1, 3, 5, 6, 6, 0, 3, 6, 9), (70, 1, 3, 5, 6, 5, 0, 3, 6, 9), (71, 0, 3, 6, 6, 7, 0, 3, 7, 9),
            (72, 1, 3, 5, 6, 7, 0, 3, 7, 9), (73, 1, 3, 1, 6, 3, 0, 3, 3, 9), (74, 0, 3, 4, 6, 4, 0, 3, 4, 9), (75, 1, 3, 5, 6, 6, 0, 3, 6, 9),
            (76, 1, 3, 5, 6, 5, 0, 3, 6, 9), (77, 1, 3, 6, 6, 8, 0, 3, 8, 9), (78, 1, 3, 5, 6, 7, 0, 3, 7, 9), (79, 0, 3, 6, 6, 6, 0, 3, 6, 9),
            (80, 1, 3, 5, 6, 6, 0, 3, 6, 9), (81, 0, 3, 6, 7, 6, 0, 3, 6, 10), (82, 1, 3, 5, 6, 6, 0, 3, 7, 9), (83, 0, 3, 5, 6, 5, 0, 3, 5, 9),
            (84, -1, 3, 7, 6, 5, -1, 3, 6, 9), (85, 1, 3, 5, 6, 7, 0, 3, 7, 9), (86, 0, 3, 6, 6, 6, 0, 3, 6, 9), (87, 0, 3, 9, 6, 9, 0, 3, 9, 9),
            (88, 0, 3, 6, 6, 6, 0, 3, 6, 9), (89, -1, 3, 7, 6, 5, -1, 3, 6, 9), (90, 1, 3, 5, 6, 6, 0, 3, 6, 9), (91, 1, 2, 2, 8, 3, 0, 2, 3, 10),
            (92, 0, 2, 3, 7, 3, -1, 2, 3, 9), (93, 0, 2, 2, 8, 3, 0, 2, 3, 10), (94, 0, 3, 5, 4, 5, 0, 3, 5, 9), (95, 0, 9, 5, 1, 5, 0, 9, 5, 10),
            (96, 0, 3, 2, 1, 3, 0, 3, 3, 9), (97, 0, 4, 4, 5, 5, 0, 4, 5, 9), (98, 1, 2, 5, 7, 6, 0, 2, 6, 9), (99, 0, 4, 5, 5, 5, 0, 4, 5, 9),
            (100, 0, 2, 5, 7, 6, 0, 2, 6, 9), (101, 0, 4, 5, 5, 5, 0, 4, 5, 9), (102, 0, 2, 3, 7, 3, 0, 2, 3, 9), (103, 0, 4, 5, 7, 6, 0, 4, 6, 11),
            (104, 1, 2, 4, 7, 6, 0, 2, 6, 9), (105, 0, 2, 2, 7, 3, 0, 1, 3, 9), (106, 0, 2, 2, 9, 3, 0, 1, 3, 11), (107, 1, 2, 5, 7, 5, 0, 2, 6, 9),
            (108, 1, 2, 2, 7, 3, 0, 2, 3, 9), (109, 1, 4, 7, 5, 9, 0, 4, 9, 9), (110, 1, 4, 4, 5, 6, 0, 4, 6, 9), (111, 0, 4, 5, 5, 5, 0, 4, 5, 9),
            (112, 1, 4, 5, 7, 6, 0, 4, 6, 11), (113, 0, 4, 5, 7, 6, 0, 4, 6, 11), (114, 1, 4, 3, 5, 3, 0, 4, 4, 9), (115, -1, 4, 5, 5, 4, -1, 4, 4, 9),
            (116, 0, 3, 3, 6, 3, 0, 3, 3, 9), (117, 1, 4, 4, 5, 6, 0, 4, 6, 9), (118, 0, 4, 5, 5, 5, 0, 4, 5, 9), (119, 0, 4, 7, 5, 7, 0, 4, 8, 9),
            (120, 0, 4, 5, 5, 4, -1, 4, 5, 9), (121, 0, 4, 5, 7, 5, 0, 4, 5, 11), (122, 1, 4, 4, 5, 5, 0, 4, 5, 9), (123, 0, 2, 3, 8, 3, 0, 2, 3, 10),
            (124, 1, 2, 1, 9, 3, 0, 2, 3, 11), (125, 0, 2, 3, 8, 3, 0, 2, 3, 10), (126, 1, 5, 4, 2, 6, 0, 5, 6, 9),
        ],
    ),
    10: (
        "eNqNVglcjWkX/997u90Wt7KkLCGlIuunrMlSiRJFltAoZDKGISP7NoT4BvHD2BNRaNGnve5933uvSlzVJDs/IYXM"
        "vBoq9M3vO88NWef3vfe+//Ms5znL85xz3kcQ2GOcwbCwEFjZIQrAns6LGY70AaKvX0wwhe3C3cDAa0UV+4HIdhFs"
        "0t2XEMsAk1VvVspS571YHlXdTDD64czpV62gP/9tlT8gOJZz+oLZ7fH8G7U7dYn/6hKIU80qTSoxZyYe2Ja3SBUh"
        "sGDqXicmre/eSan+EKW2vG95D7NC8aRNlVmGGMvKlvTOyOXtcc2ecZU6AnfRo7qMazh39icRiX0uYcKLBzN05jhF"
        "IcgbeEstYrFiKlTWqJLgOXBLjpiBGLUOolipdDQQa4Fpy2HDQ68SNG9yCwNjsN5Tehw6W6e6C+5TDMOrFhsYJZsn"
        "GYnaoI1IN6GDvVwDt7epC7seyq2+Gzm/ZlnAYTFk+4BRk4AdptQFutGGhpP1h4hzDL2myZpk061hWLzlalu0K30m"
        "hvipDnRdNhGpYzGLfqGeL1gyDZ/+Z6qLR5rzYofrDhNh/JQkziAtNlfN0exyf4gSAoDglxx33iie03qH/4w295vr"
        "w/02cPyVGzGPi9mtB8nzGH8Myeug5LMdaMyrjkCeV8MOdxLpcEkiNbKCtoRTyziuIea9pww97nHcxsBQaoePI9hx"
        "QJNis30exis6SSB5FjcOgxRdNFyGjXhXvqrzDxHwS7xgC/3wZ2FcUqcXEzAh9xbj+204hue0/o8y2yaO4/KqSdDs"
        "XwBRUWtg7AHq0ZGj/zlqJLgCtvnUcMtTqgfet4bNNa0T+pU715fWj+EnYOKRP8SQVOcPgcvlXjzP9bbO5M5bZLvB"
        "bd8zUnQz1w/+gnWScvHTFfrookn0RcQ8W03+bnGmHKATy4Sc+aW/e/jqTUOp4YIux9b/e3trnF4so51JCwIkc+w5"
        "enT+61pDqBFxvAvQds92SOfFTUn2QggFokuBdswVuza3gqBPYeWUAmygWIuj0LGkFRQdCEjTZJCWIzEt4XjNaWq8"
        "WXx21Ng0vu+hmV3uGD9+Jnlk0P2UtLza5JHxthV++zN8p8eHntkpH3RnAKT+I4B+KRdzvpewzXptwaw5ty2Y0CjH"
        "PoGI38/Q6lPaFhdUekCSB3hGwZVi0eg6fp3ItrRrLccX+dA59ionEN0lcPOp5fIbsqjVQyBoq63lFAonhFzhU63g"
        "oTDE6FxkDqDFB6SPZLoNqGwkfH+ScAyTs2UIiANWXVXGt0Itp7wQxALFOHciC5e+GobSKoaGDxkOTSNsXjCMODV+"
        "xM9xYR/SqBHY2MBPu5u/xWf/2RjmFOaltYdHuhRLM5HpTEGdLHlnd5UMYdwNqGnQrA6BxLLyJUSbrucGC+8kfIlM"
        "B1f7ldl3zzu9n7wqesusbG54ay970YBVkaUAA80AmoyeTVMLfmO230wm/MskO5Qtal/RlS0NKJZ95s7XoFaj0UTW"
        "nabWiTqhRAJRviAcHYA++wVhylosGy8ILdTIMiHbeKssZu/ymHBGev7dHUKdUme9ehjDEbzOH344w2EqnW/KEQxd"
        "1TrXcusQrM3XzoCnxgxmGvecgTQ4KLvCgIhBhY4YPsoeRGRw5kiNKbG4YeaVfG0QiwONM4upS0xONYuzHIq9lE6f"
        "nxfJvzztnXzXRvlpjfLLG+U/z9LJV7sx+WpvzLh8saZmvm5tKwoi/spQJqnH7wxFzxl6niH1F57r6mb4MoZ9Ehka"
        "3RHjX1nKbCsUt8eEeDy2hXQIgioPDydZzYNL1pmTJvOqVo+s4FAIrwJlTnc/Kn0c5//B2v+XCO8j5XP4QwK96sxR"
        "8E6343nebussVhV6uZ6lQnQDkrt68N1JnyYXHCSbpkSgVI9itaCPrvoqdo9nJOwvY8pwyuaSHcBO/zlbIddSpudb"
        "dFfAY0OxTFoC0X3R2pGHBzjT9ybDPlU+a+GP3wFrAhXoGnfcGnDP2QWRVkGymr2lj9T5WNqyRMCxUILzrsiiXLfP"
        "n3CQ6dr5oCUjR+51ZEeQ4EHVWK+wMxLGIWwT0OG6cbdSMXC5O05NgXc80LVUrOlGrLEHT+oq5X/tv7E/v3Kc+g3r"
        "/LSZoG2JEWG8N4HnWXb0Re0JN4QxhtdqSsBmNzjJFx/Bd3+aErHPBXYxIb4+zC12jWEfXmBBbwKblax5lIGPWEIl"
        "4OuSBN2UO3PgyHa68Xy/3RT7mg+eK6ftPxNEZgQ5LXXUXF2EfUNaPIY8JPIlMkLa16Da1PY1fik7+eTj7N2mVlnX"
        "Tcb0pFp9yKpeSiArr/fB9GghWpVi3iqRy2p9LADB+x7pQ2KqK6jnJmH2ZhtKEbMmIRYp6mjh+DT41j+UQe/VExn0"
        "a5MmYXKdtUq1RWh+IkfVD4f6o0MxHpJ5tyWVBhC74mwAhRes0vnczoDDUlNcX2CMP4G5DVwzfKVikZbj1d/QElkd"
        "3RPOqr6qTGX3j7yL4Ev96hbB7kE9Wfui5tMYd5yr4/vw6zfj077kz/jYj8tA698dBX3FCAgHKRvq8inyBHF2CE2Y"
        "3+0nfLwQl5YLR+6Gnri3qL5/h7/7dXxcK0G9WKdVwBckgi/xq12Ezl+10TJNlWYZG4jAExUyyCoeM4idhmmxbdNV"
        "6W3++fSabP/n82lyUTi6oM4TL8VNsYb5RVdG4qncIQbRSR7Ud008aspLjZ9gibboR3azFrC+IatpQY0Yqec/LSY1"
        "5JNZ/UNHzKvzK1NGCsXtILslXjUXo3bBPgN7XIBLJnl09Vi1aSfLxtdU3m52RGYUhp2KChRn81jz3eiDPbdmynMs"
        "DItDx673UVPByGrpodwILCyDvMEFdFk6ENi+yDmdCs9jqh1rHvSAnaonL1IMwt7ZRbYwuS2iG+bkSFipcJKSjWtH"
        "xQhz41ez+vzGltAqh2BsUR+wa7PmLZFV66lgF0qhV0ALVq+jkTcXOM4QUWsh6DX6630GXsnvfX8hQdQaoelZuwN6"
        "HzbmtDdOejW2qUas2YFIxbgeIRtNtuRa/w9IfoMe"
        ,
        [
            (32, 0, 0, 0, 0, 2, 0, 10, 2, 10), (33, 1, 2, 1, 8, 3, 0, 2, 3, 10), (34, 1, 2, 2, 3, 3, 0, 2, 3, 10), (35, 0, 2, 6, 8, 6, 0, 2, 6, 10),
            (36, 1, 1, 5, 10, 7, 0, 1, 7, 11), (37, 0, 2, 7, 8, 7, 0, 2, 7, 10), (38, 1, 2, 6, 8, 7, 0, 2, 7, 10), (39, 0, 2, 1, 3, 1, 0, 2, 1, 10),
            (40, 1, 1, 3, 10, 4, 0, 1, 4, 11), (41, -1, 1, 3, 10, 3, -1, 1, 3, 11), (42, 1, 5, 5, 5, 7, 0, 5, 7, 10), (43, 1, 4, 5, 5, 7, 0, 4, 7, 10),
            (44, -1, 8, 2, 3, 2, -1, 8, 2, 11), (45, 0, 6, 3, 1, 3, 0, 6, 3, 10), (46, 0, 8, 1, 2, 2, 0, 8, 2, 10), (47, 0, 2, 4, 9, 3, -1, 2, 4, 11),
            (48, 0, 2, 5, 8, 6, 0, 2, 6, 10), (49, 1, 2, 3, 8, 6, 0, 2, 6, 10), (50, 0, 2, 5, 8, 6, 0, 2, 6, 10), (51, 0, 2, 5, 8, 6, 0, 2, 6, 10),
            (52, 0, 2, 6, 8, 6, 0, 2, 6, 10), (53, 0, 2, 5, 8, 6, 0, 2, 6, 10), (54, 0, 2, 5, 8, 6, 0, 2, 6, 10), (55, 0, 2, 5, 8, 6, 0, 2, 6, 10),
            (56, 0, 2, 5, 8, 6, 0, 2, 6, 10), (57, 0, 2, 5, 8, 6, 0, 2, 6, 10), (58, 0, 4, 1, 6, 2, 0, 4, 2, 10), (59, -1, 4, 2, 7, 2, -1, 4, 2, 11),
            (60, 1, 4, 4, 6, 6, 0, 4, 6, 10), (61, 0, 5, 5, 3, 6, 0, 5, 6, 10), (62, 1, 4, 4, 6, 6, 0, 4, 6, 10), (63, 0, 2, 4, 8, 4, 0, 2, 4, 10),
            (64, 1, 2, 8, 9, 10, 0, 2, 10, 11), (65, 0, 2, 7, 8, 6, 0, 2, 7, 10), (66, 1, 2, 5, 8, 6, 0, 2, 6, 10), (67, 0, 2, 7, 8, 7, 0, 2, 7, 10),
            (68, 1, 2, 6, 8, 7, 0, 2, 7, 10), (69, 1, 2, 5, 8, 6, 0, 2, 6, 10), (70, 1, 2, 5, 8, 6, 0, 2, 6, 10), (71, 0, 2, 7, 8, 7, 0, 2, 7, 10),
            (72, 1, 2, 6, 8, 8, 0, 2, 8, 10), (73, 1, 2, 1, 8, 3, 0, 2, 3, 10), (74, 1, 2, 4, 8, 6, 0, 2, 6, 10), (75, 1, 2, 6, 8, 6, 0, 2, 7, 10),
            (76, 1, 2, 5, 8, 6, 0, 2, 6, 10), (77, 1, 2, 7, 8, 9, 0, 2, 9, 10), (78, 1, 2, 6, 8, 8, 0, 2, 8, 10), (79, 0, 2, 7, 8, 7, 0, 2, 7, 10),
            (80, 1, 2, 5, 8, 6, 0, 2, 6, 10), (81, 0, 2, 7, 9, 7, 0, 2, 7, 11), (82, 1, 2, 6, 8, 6, 0, 2, 7, 10), (83, 0, 2, 6, 8, 6, 0, 2, 6, 10),
            (84, 0, 2, 7, 8, 6, 0, 2, 7, 10), (85, 1, 2, 5, 8, 7, 0, 2, 7, 10), (86, 0, 2, 7, 8, 6, 0, 2, 7, 10), (87, 0, 2, 10, 8, 10, 0, 2, 10, 10),
            (88, 0, 2, 7, 8, 6, 0, 2, 7, 10), (89, 0, 2, 7, 8, 6, 0, 2, 7, 10), (90, 1, 2, 6, 8, 7, 0, 2, 7, 10), (91, 1, 1, 3, 10, 3, 0, 1, 4, 11),
            (92, -1, 2, 5, 9, 3, -1, 2, 4, 11), (93, -1, 1, 3, 10, 3, -1, 1, 3, 11), (94, 0, 3, 5, 5, 6, 0, 3, 6, 10), (95, 0, 10, 5, 1, 5, 0, 10, 5, 11),
            (96, 0, 3, 2, 1, 3, 0, 3, 3, 10), (97, 0, 4, 5, 6, 5, 0, 4, 5, 10), (98, 1, 2, 5, 8, 6, 0, 2, 6, 10), (99, 0, 4, 5, 6, 5, 0, 4, 5, 10),
            (100, 0, 2, 5, 8, 6, 0, 2, 6, 10), (101, 0, 4, 6, 6, 6, 0, 4, 6, 10), (102, 0, 1, 4, 9, 3, 0, 1, 4, 10), (103, 0, 4, 5, 8, 6, 0, 4, 6, 12),
            (104, 1, 2, 5, 8, 7, 0, 2, 7, 10), (105, 0, 2, 2, 8, 3, 0, 2, 3, 10), (106, 0, 2, 2, 10, 3, 0, 2, 3, 12), (107, 1, 2, 5, 8, 6, 0, 2, 6, 10),
            (108, 1, 2, 2, 8, 3, 0, 2, 3, 10), (109, 1, 4, 7, 6, 9, 0, 4, 9, 10), (110, 1, 4, 5, 6, 7, 0, 4, 7, 10), (111, 0, 4, 5, 6, 5, 0, 4, 5, 10),
            (112, 1, 4, 5, 8, 6, 0, 4, 6, 12), (113, 0, 4, 5, 8, 6, 0, 4, 6, 12), (114, 1, 4, 3, 6, 4, 0, 4, 4, 10), (115, -1, 4, 5, 6, 4, -1, 4, 4, 10),
            (116, 0, 2, 3, 8, 3, 0, 2, 3, 10), (117, 1, 4, 5, 6, 7, 0, 4, 7, 10), (118, 0, 4, 6, 6, 5, 0, 4, 6, 10), (119, 0, 4, 8, 6, 8, 0, 4, 8, 10),
            (120, 0, 4, 5, 6, 5, -1, 4, 5, 10), (121, 0, 4, 6, 8, 5, 0, 4, 6, 12), (122, 1, 4, 5, 6, 6, 0, 4, 6, 10), (123, 0, 1, 3, 10, 3, 0, 1, 3, 11),
            (124, 1, 1, 1, 11, 3, 0, 1, 3, 12), (125, 0, 1, 3, 10, 3, 0, 1, 3, 11), (126, 1, 6, 5, 2, 6, 0, 6, 6, 10),
        ],
    ),
    11: (
        "eNqVVwlcVFUX/78ZYJxhcxARnIcosYiBC7ikqYlCmVsoLlmm5AYYLkmQuZVfYlBaiii5fKa5IkigEmIOvoGBgUF2"
        "GRYDUfGrcNByC6Kicx9oLtjvi3n8z3l3O/ece8655/FG/uEPlvIcvs1IT48qHTB8yQ5rYL7vIQCf2RPG1BwomQPp"
        "/qlT4VVQezV3KBaM+po6v7TeQwirSAJVXHO4Caojb36xUflbb6NqIS4k/aKkzqjWpskAb5xukF/sZRxUgmX5Lbkj"
        "WQvNiq0MhizNzPLu899j7StQNI809DpI7avypx10YmvDb+3S9AmA6Wnlbe9yIGKSVbN3LRyOAjuqlsBPyBSsIfvZ"
        "kQ2V/dAbDtXAi7dKdK1qFAQxGcp7oijJL16ixFdzhSwNmNI9SNOJCvRJol3MAq44wKIZ6P4zIP3VFBB8gDc3AJJE"
        "hfMQmGbJED0XE5PhUYM+DRhcgIWbkdrPLa5dkXWTjONCbHdfX2neL9EmvatFV/SUdKgoYndB1yokP9oicZ94NnX0"
        "GmE9Mz61RQ4nSOYAx1hiVowhOCEF7OOJWfIyQaIJwM0Up5/LOaZA0nxsX437lhidq7wLuNQr7wCul9tbkCj28mo2"
        "0v1c43M1oUYrCya3k3+Hk8IFHxwMxHQdNpnBo44Jid1EMC9XBkwp7QaMLnMAuv5iEIRE+GUL+SPMGlR4qUzaA1hW"
        "CNhcuuHNZq3e6rsIcLvqXm2J0G8RUiKkqFj7GlHvFysYURrGMpIyl4lfdoDtwKoqlwx07IFtOsjZHEGIQLkpe69m"
        "YFl1RHvQzrnYBeuTLGg/bvUelxRYnIj3ioQkO8gP6jId8Fk4wnfjBzs4hHVtDtckqex+90dkqvQ2WecKzvpgQTJc"
        "1UK6arwgCEWNbN0Y5sC2deaEnzK2+2XGfvY+gV29BeFmxuLNC4JmoOKePfz0Zg198Xo5xrdU3BrO1Y5D5OZudAau"
        "V/Fjf8w9j7F5WZnu8M4SkruibgiCY9gJuRWh3hfh1+Fz9tzqy/hYilfSoffDoTnkTvnRkGthLepODvGA77MlLCTd"
        "mRgbb9huOuYVvW8gcDSarA7vo9uZ1w942Z70EILEmWjn/Ri77uR4QvPwlCEURIkTAlLelWNpF9bzglajHYAGb0zO"
        "ky0AhtSwxr3vEUw+TA6IVDNxKQbybIbSxRm6U0MpCNNiLTHqWl+sjXdK/yb6nQQ0uAhB8m/61yjvKpql8jUeBuXv"
        "yntdVkyO2ILvfcOPLDq6RYHZVf0hW+RF60w4l/ftDLZg75Z1jKz6sIiRfKXWhcyTihVk5vWX8or1QAmpX+TkpaHu"
        "jSs3riIyPJdvFbRFY5lnTK1g+Fwpw3kjqL2wLYHxAQ0MX9RQS6a6H7CwMDsvEJiRZQW7SwNh8GGnGCj/VSIay6Kl"
        "neLyIILQVxF63gKOtU7g1lRoBF/QKuezp4mu2K3UX3TMGekica8TiWelSIJE2arKwTRB0PizeQIF+yOe/Ahhfcs7"
        "axTM2uf9nSIeImt/4+l2YFpOTvE2BWbqu0OWsgfVL7BNHVH+JhV7zVuksBGyi/A9ax9hxDy9LSyTWNSVa78LNIqr"
        "8M8gTKbuWUMe/z2138fQls7QsVHS5IzZWrxaIGR5sR4z9etEuMMRbFzMDjZwyUmWMlsr88j9+Dvmx3aLa1hULRSX"
        "8rw5tHOD/hNp1dKfGd+mpheuwcg3XbUlQxTTnuMpTX2+lhi/DOCSFzEm122Gponq7Hz703kiM+q0wVpkuPpTTO82"
        "MYPzTUVeohUCj4uEK/UQB808LBJJ2VjRJm+oRSKpIogs0RWQH4ZkKMhNhuKyJ+1nzgnzZhZtz1crROpZhToWJG8l"
        "IVgcR3H7fmnehcB2P3xe9O9Mhs5XGc5PYWd0QtWZX5A8/Wsd8gyDOuQldMir7JB3pUNeSru8EgqO90sK7jfMbV+j"
        "50gx3gazNadpxXi7xjB4L7Xr6i0ZH7+I4Yz9DN2rMO58VrqdtLEbIvZa/OYA6xH4sHHXSFYcLK2PcB5MmafWm05g"
        "khoLLpw/67KXXYrCqn91osa/4R/IDZs7nJiOy8jqUfvRN0OTe1i55hOWNgvcDSypvIdyN6DCCR9FoF8u4JWDdcup"
        "w2BXyG6sTZtY6oF36zvALtpiSFsv4Dvf2anAMT3VQj/JHOjqqJ61m7I5URf3NFsDllP+2vXW4nCU2SWSNWfHHxmE"
        "uMCL5NYOJWUcpp9OYmtWnqAb5o9QymhldLUlhmLHB5ii5mBVM6CS1TwBd4PZsKD/sRypumhfSSn/2wD4lpjNP8GK"
        "rqgoViGcC7BscIU/5efQZK5gGGBiiE1g86a0Oj/Dbp9QSP/0ATFONXSjc2oqy7D0KwLXKsq2Ei27NiJ3suHNepal"
        "7GsF62eUDA//2RguWSwY2G00hplQKqoZzy6Ql0lNmBxn73so9DDQ3YfyEU3s7GFdcBMviC+P07Vru29MGJUOvjjJ"
        "mWQC4eNn0a7SPeLgKZwvnEYVxGR4V1HZF7B21w1AG+E6jCrZli6YcxP4uCTj89+5J40QpdH/14JvWwBu31aeZf8B"
        "Nfx98pT+pXzbbEj2fMg37c/RRplClarRjSIjz0K/BomcDbHhzDuui8IZGFgB9MvK0gzCE0a2PSDotxtxagm4LUbZ"
        "fcrDfY0WLVS5eRmRHQYuzgintNzsD4ywO3I2PwRI84GswlPeTJpdnKpgEgbbQDcLqkY7uGRo8umMBq3qaXYrqFvP"
        "JiCuVbDv7BRg85VQsM2IVFGuWbtc86flrmtABtVpYYkYJpxRJ/R4PHdsFQwT+T/fxvhK/g8zON7gbz6IqAfYe+Pj"
        "+R8eazoWeOJx/VFau+2JzCTXUsUnTQ0mfi8FCt+mSZWAb+ISYsVe/bud+EQTzC+v4psOXpubeG0x39b3pT89Rlfx"
        "9+BIT+ODYU/TL4QKURP/Sv7PzjWBfWJW7rYuOLOcfGGTvJlMNcDQQZCxgho/gcOJbF2c/P/3mse97V/4wmM+xBsP"
        "beDbqPq488QZRxcXDrduMfWN43THx1FUTcraOeCMxKuOi71QFkTfYDToZKvw0HY9b1FKOPOozgx7GVW3AB+jotkJ"
        "nxoRVpMZYywaAWwPWbENXJ3Srl4yksL19Ohtk4CZOwppu7Ifv6BEORyLWi2wPThqPQ7TB1llz6HZyH9ts2MeXY4+"
        "X1vr51NiiT81D3kZVHeNb3NEzCXgSDh8c6XKGrdiV6r+brJkMPP6WkqHF+0v9kf6DPgWmxa8BOx/OzQesmvm1ldN"
        "AuiT8vArx6hiGZegZ9d23UpWh5ZTxvKteJPYrYLQtJpUqFbCupLyXtIKymLfUEdLkSCEcYf+43Cbxb3jDUTsQuRu"
        "xrBvnNuc5OiGp2sX9ktYh+d+YoNUTTDN8zfN9ieGXqkx4SPEqCd7LdpoFa3u8xfBNu/7"
        ,
        [
            (32, 0, 0, 0, 0, 2, 0, 11, 2, 11), (33, 0, 3, 2, 8, 3, 0, 3, 3, 11), (34, 0, 3, 3, 3, 3, 0, 3, 3, 11), (35, 0, 3, 6, 8, 6, 0, 3, 6, 11),
            (36, 0, 2, 6, 10, 7, 0, 2, 7, 12), (37, 0, 3, 8, 8, 8, 0, 3, 8, 11), (38, 0, 3, 7, 8, 7, 0, 3, 7, 11), (39, 0, 3, 2, 3, 2, 0, 3, 2, 11),
            (40, 0, 2, 4, 10, 4, 0, 2, 4, 12), (41, 0, 2, 3, 10, 4, 0, 2, 4, 12), (42, 1, 6, 5, 5, 7, 0, 6, 7, 11), (43, 0, 5, 6, 5, 7, 0, 5, 7, 11),
            (44, 0, 9, 2, 3, 2, 0, 9, 2, 12), (45, 0, 7, 3, 1, 3, 0, 7, 3, 11), (46, 0, 9, 2, 2, 3, 0, 9, 3, 11), (47, -1, 3, 5, 9, 3, -1, 3, 4, 12),
            (48, 0, 3, 6, 8, 6, 0, 3, 6, 11), (49, 1, 3, 4, 8, 6, 0, 3, 6, 11), (50, 0, 3, 6, 8, 6, 0, 3, 6, 11), (51, 0, 3, 6, 8, 6, 0, 3, 6, 11),
            (52, 0, 3, 7, 8, 6, 0, 3, 7, 11), (53, 0, 3, 6, 8, 6, 0, 3, 6, 11), (54, 0, 3, 6, 8, 6, 0, 3, 6, 11), (55, 0, 3, 6, 8, 6, 0, 3, 6, 11),
            (56, 0, 3, 6, 8, 6, 0, 3, 6, 11), (57, 0, 3, 6, 8, 6, 0, 3, 6, 11), (58, 0, 5, 2, 6, 3, 0, 5, 3, 11), (59, 0, 5, 2, 7, 3, 0, 5, 3, 12),
            (60, 1, 5, 5, 6, 6, 0, 5, 6, 11), (61, 0, 6, 6, 3, 6, 0, 6, 6, 11), (62, 1, 5, 5, 6, 7, 0, 5, 7, 11), (63, 0, 3, 6, 8, 6, 0, 3, 6, 11),
            (64, 0, 3, 9, 9, 10, 0, 3, 10, 12), (65, 0, 3, 7, 8, 7, 0, 3, 7, 11), (66, 0, 3, 6, 8, 6, 0, 3, 6, 11), (67, 0, 3, 8, 8, 8, 0, 3, 8, 11),
            (68, 0, 3, 7, 8, 7, 0, 3, 7, 11), (69, 0, 3, 7, 8, 6, 0, 3, 7, 11), (70, 0, 3, 6, 8, 6, 0, 3, 6, 11), (71, 0, 3, 8, 8, 9, 0, 3, 9, 11),
            (72, 0, 3, 7, 8, 8, 0, 3, 8, 11), (73, 0, 3, 2, 8, 3, 0, 3, 3, 11), (74, 0, 3, 6, 8, 7, 0, 3, 7, 11), (75, 0, 3, 7, 8, 7, 0, 3, 7, 11),
            (76, 0, 3, 7, 8, 6, 0, 3, 7, 11), (77, 0, 3, 9, 8, 10, 0, 3, 10, 11), (78, 0, 3, 7, 8, 8, 0, 3, 8, 11), (79, 0, 3, 8, 8, 8, 0, 3, 8, 11),
            (80, 0, 3, 6, 8, 6, 0, 3, 6, 11), (81, 0, 3, 8, 9, 8, 0, 3, 8, 12), (82, 0, 3, 6, 8, 6, 0, 3, 7, 11), (83, 0, 3, 6, 8, 6, 0, 3, 6, 11),
            (84, 0, 3, 7, 8, 7, 0, 3, 7, 11), (85, 0, 3, 7, 8, 8, 0, 3, 8, 11), (86, 0, 3, 7, 8, 7, 0, 3, 7, 11), (87, 0, 3, 11, 8, 10, 0, 3, 11, 11),
            (88, 0, 3, 7, 8, 7, 0, 3, 7, 11), (89, 0, 3, 7, 8, 6, 0, 3, 7, 11), (90, 1, 3, 6, 8, 7, 0, 3, 7, 11), (91, 0, 2, 4, 10, 4, 0, 2, 4, 12),
            (92, -1, 3, 5, 9, 3, -1, 3, 4, 12), (93, 0, 2, 3, 10, 4, 0, 2, 4, 12), (94, 0, 4, 6, 5, 6, 0, 4, 6, 11), (95, 0, 11, 5, 1, 6, 0, 11, 6, 12),
            (96, 0, 4, 2, 1, 3, 0, 4, 3, 11), (97, 0, 5, 7, 6, 7, 0, 5, 7, 11), (98, 0, 3, 7, 8, 7, 0, 3, 7, 11), (99, 0, 5, 7, 6, 6, 0, 5, 7, 11),
            (100, 0, 3, 7, 8, 8, 0, 3, 8, 11), (101, 0, 5, 7, 6, 7, 0, 5, 7, 11), (102, 0, 2, 4, 9, 3, 0, 2, 4, 11), (103, 0, 5, 7, 8, 8, 0, 5, 8, 13),
            (104, 0, 3, 6, 8, 7, 0, 3, 7, 11), (105, 0, 3, 2, 8, 3, 0, 3, 3, 11), (106, -1, 3, 3, 10, 3, -1, 3, 3, 13), (107, 0, 3, 6, 8, 6, 0, 3, 6, 11),
            (108, 0, 3, 3, 8, 3, 0, 3, 3, 11), (109, 0, 5, 8, 6, 9, 0, 5, 9, 11), (110, 0, 5, 6, 6, 7, 0, 5, 7, 11), (111, 0, 5, 7, 6, 7, 0, 5, 7, 11),
            (112, 0, 5, 7, 8, 7, 0, 5, 7, 13), (113, 0, 5, 7, 8, 8, 0, 5, 8, 13), (114, 0, 5, 4, 6, 4, 0, 5, 4, 11), (115, 0, 5, 5, 6, 5, 0, 5, 5, 11),
            (116, 0, 3, 3, 8, 3, 0, 3, 3, 11), (117, 0, 5, 6, 6, 7, 0, 5, 7, 11), (118, 0, 5, 6, 6, 6, 0, 5, 6, 11), (119, 0, 5, 9, 6, 9, 0, 5, 9, 11),
            (120, 0, 5, 6, 6, 5, -1, 5, 6, 11), (121, 0, 5, 6, 8, 6, 0, 5, 6, 13), (122, 1, 5, 5, 6, 6, 0, 5, 6, 11), (123, 0, 2, 3, 10, 3, 0, 2, 3, 12),
            (124, 0, 2, 2, 11, 3, 0, 2, 3, 13), (125, 0, 2, 3, 10, 3, 0, 2, 3, 12), (126, 1, 7, 5, 2, 6, 0, 7, 6, 11),
        ],
    ),
    12: (
        "eNqVWAdYVMcW/u8uS9mlLKIiGpoiLjZEokYTnw2NRKMm+OJTg+ahPkt8GAuWgLGDBiSIisaCJViIXSIanqJCMBIV"
        "BZUtdKQKKrZ4DbL7zszFxCiaL3e5559yZuacMzPnnItG1LzwUyaof3qxDsgOea8E0D4ycAxBQGCkFxBbkFGZ4ggk"
        "We0D3PUPimv2AN5Lpw4njgkfxTkTrG2XBPawKTCixHTZxaJuijh/l6uxk+j2uVllvCgA3X8xXXFjPDtOj5igEXvd"
        "nfWwrzg60zy+2pjt0zj22/JgYFK2mWPDPyphW94DzY0jbiEqmrrCDRM9DSq+DE4MlXBYwqfpZ/oA5hkev7UbrgdC"
        "ApsbXYeWwvEAEFqUFwDv87o8JelVGsAHOBvlsPknYFboLy3oe7+i0KhrI2TPkrM662do8cSvUZksbekVJpxkn93t"
        "0fs4wUSgSgMHkwXa1YMjq/N21o9d7UeHQJZrj5hgjE1Gr1J0fsAolWOCqT0gpNFaZkO9RPMhqoVJDbumwTx1bjww"
        "+TPEvN1ojz/DEB3JqnN5qa/3GcQuE0pcVujSlXvVF6ilx9fMXr2JpJLdNZuo8OVgIv9TkIa7qRD8MTMi2UWYwGZQ"
        "JZSXhQvYcNRMfWOScK8XMO2sk4ls/V5V+2fU3+VRY62xjzjldjcmPR/XL+vX0OpwcYQdk+c17+DLhgxNqwoPLE/7"
        "hI6Pz1227vQz7KxV+wKt8kgQdfZsQJkRRo0bGnQ63S8Yl2P4uWv3AicszBo9mfSqZsLuWQi8L5Z0pbJ5zOW4zrSJ"
        "tVGJlrLo/TYJZfk71GzmhZKB3KskPLmA479OcIupC905bv6SS+d028DsKn/B2hxdfyUZIt79gY/cyGjI3nTdtzbr"
        "Muytjm12siODlH3RE3ineFGKpSIxymJ7SWGMJTBTX7DfDoGnLOR7t+L6O4DnXBtT4OXctcq2xihzux/Xu5lobL9b"
        "iidk0z5F2Lcalscj0OxwiX6N+Y+05q17bLHY5URa3W5GNIrtZ/MaR7arsUTsa94iunQLEdvbbRlzt9N6Q2JrWcUk"
        "yGLOOBtpn3vUynPnyqx2RKB/fZ1Y3cms9AuZ5fZM3vd2rawyEELkEfie1et2O6BFgqF4nRlS1ggWx0PURibXFQcu"
        "5T2kxSjUx+7DKUGfNjvPLIL6pu9C5gK0vOEDj9T8nGFQX1bukMzGzt8fNTLN3vCJl5xYiXarw74jbtsP+aDufap/"
        "cH51czp+ARcjqCIbr9SxBy88Uos3Kybv78DmOhHvyq58HeyXpw5bkREgYJyMdffI1F/qLisfhWlZdt/I0KeGNX69"
        "mV3uq3Zs811Yw2BJPkb5HSEVE3Pz45khQwsGC7ZLylrhw3zX7/OjQvbHIXP8pi2KK0s/LLQ1tRTb4scR3eraNbg3"
        "CPKqt/xy1KaOT53HPREOzcLFsCnnFn1zep6A3ndnqASPcGt2XQ4U5+7pwdfILeLQKfumD8OlyyPZruKm74AbBB1v"
        "QXG/PbDkQXHx4/nAjb7AuIvwuk162T5p/dU27us+1xh12py+/ExOucnBu5ZD2CpQX1HFfxXcZ8Xu5cfXp4ZD2FE2"
        "Tp/YEhh0UaeLsqLdLOsG1QFyB5nTiKH1Q4WdkZ0p2AruRkEyu0UDbyE1Lv2HsEOVAP/yTrBNXkK1sdf1N0LlbE1t"
        "XmJ7LoJsfFU76dKs3SnhQL2E3ncl9L8m4bY1DBUzihz4+J1ObB56hjTh6CD1ZeP1fboJfzk8+TXDG+84Bl3QFcTZ"
        "klmKOsA+LZHMMolaex6X2xlbShy043DU5ZXBkre8SyOzGA9zJ6PKNPDOYHNNNmhT/MTGeaU40SRyeQvFv+R75feH"
        "1E1Rc09G3Z4J6PpAXuWHxecwMEefruH9Ey4pGfbLd2L8nsVdGa+D7gM28mn6KT6DaXVFoDTfgAedpHmX6qw5ys/t"
        "f6MR3wimKnqmaEznqCJUkh6ldB19C6iwm6JxWBwVxm4HMoZToVkpmuVyXdO6jV3LCyGLdg/gBc1PBjPJDIZEZh/T"
        "YW6mp7ku3FrBqznYFFlxpthJHDyzpCEnp3Dwz+Eg6IkMuXCrPIkUfb96EGSTbrsji10HbN5mb2rFT2yRh5F7lm4P"
        "f29p5Pl2mzQq6LYbm6es4odO0nVIlkJK2FkO3Wp5bI88zvZcH9/izeeQ5Ck71uG5PJXOz+XZ9Hz1/OfyPHjeUozL"
        "kjxb4cflKSZH5pdx66GpYoY0qdDBny1enNpRWmhRpoQ+d6S8I2YzvyR1WWa8rs4bLvVHrpRwyl4JvUtk6HvJcKyZ"
        "WU1XbN7obLSC13x5wSHmmZ23P8j04G717DBa1vdOz3uemHMKn2l1p5wddTxb+fmlqPq3sZG8CTpweNLcyOMqMlbA"
        "4sh6uCbl5W21nreHzbR/dru7ZpQv1Dkjpx8wlKRaFkUmnkNG1UMoZyGi0POdi4w3eu7quQz7ntOygANZ5S9E15Hb"
        "VDxOZHw9A65SODKUUXi+L29Rr0LIVyVuCKAUWNsPx/smjEc0JTKbFwhl5lMplJClxh3pfAZeOVYV5GXbVE6nDKdy"
        "5EE2d2HGe8ChdL5nOx6bA7NMlEb6VNoDXlVOiImDcP4zwKa0exC/q59cLuLRTFaxm1so+GgJCyxuZa0CrpJ+KdOB"
        "o2H4dyYdlza3OwpZNBYR8RhSYgHHO5Spn5mD2CgWM2u6VDuwCQ7Ufskn6lmvfP0WrCO/VdzA65tYKo7+BsatzOvH"
        "KiQki6ZFNkQttUN49I3nzM9KmMdTe9TovN+QGv7+Mj6BpYSI82IRm0mmSGH1XUzpj4LZmie41JQ7IDCIxfKR48k9"
        "a8TX/bFej/uk+TcTV0F1EqcspgdhWuDPKtimjmHSjensD0WyFZxPa3X+wMF5+FhL3ypqt1GPgIn6fQdEqH5rBx+R"
        "PkXcEEnZ/qIK7XKT6uW7PENbvN5cY9wgU/60WMNu6Uitpl4KgybazeFZGlO0YJ0+QyOGF+hCZbDeqtNRhN2+QWhZ"
        "1ktRTwMGeLs28ChsZWxNl8kFyTFoXdERrZPyr4/FS55DtUmfFy5iW7xMmSKa1behaCa6sOGdRCsjqesv4tgWQZUi"
        "osXRopzZIixjbuhXyLBxi1x5IcjsaQtS7pQLi0gFaRYNlNQ5e+NgKJRn58Fhr9YQIUPXBV2sHwa5eD4FTht1771u"
        "06DcqMtfKWKLJMlvfyHJnCdIoVs1qAAJsYJFcjRaHs7Lj1P9OaKF6vL7axrCMTNbY3JF10ca9lX2RFrxRara8XK8"
        "fLVF82TIHTHyVc8blm5JMPq6PdXe1pP31NSXr2J9DZ/W+nGW4TVtOeey69ZNH67fZOpKSnqi9UV+6/WFfhpTMKY9"
        "pjdXY2qGLux9zI4Af8U/bNZ0KVTLdF6FGVznLq/VGTY7DTrayO92yFQZs8yf0c0Ykc0PTre7jbXGPtjuMtCW/+2j"
        "2XSU+tsHrqmApxFXp2mMSyg1sH71IAXdzEt1s3/mhOgkm4czrRX26JF0/4C7bWvYbcjyrXXGqGJM1+dfG4jmYY2T"
        "yinCuP8pTDwnHg2U7yqyytSvWpBRH9GDMt6RolLsLxwWMaUyZ7GYPZLlu/JFOym/Ww/3GjkuvEs54QDHYtJy9rrJ"
        "kSxnLvzBl6lyTk9EGwB1Azmp4u5rYzHs6km4VwqDchAxoVIeFA9FnUPaW6ndv6NU5/CYm1g2q4BSzcmXdsLv6lk2"
        "kykIqnr2b4AD4TDX+6NVtcf876g69Xwh826Ke2vZQosSy+lstr9lH3IUwrmpUOQG5HxE/qlCtph87OJYaKoFXKQg"
        "cr1Xi1KS86uVE2NomNe17/uw4dd13KNE8rkssym2oF/hTFaJp+9MIyscZnpNvmbO/G9HSgwyP6f6ymTuv8vIP9iY"
        "HdznUa+UzvzASmRNx4CqxivgUW9FvU2lrNLv2mr0fNTI6/SsOTYmEJWqPR6BetfolrU4GK/84kro/wE1Uy5w"
        ,
        [
            (32, 0, 0, 0, 0, 3, 0, 12, 3, 12), (33, 0, 3, 2, 9, 3, 0, 3, 3, 12), (34, 0, 3, 4, 3, 4, 0, 3, 4, 12), (35, 0, 3, 7, 9, 7, 0, 3, 7, 12),
            (36, 0, 2, 6, 11, 7, 0, 2, 7, 13), (37, 0, 3, 9, 9, 9, 0, 3, 9, 12), (38, 0, 3, 8, 9, 8, 0, 3, 8, 12), (39, 0, 3, 2, 3, 3, 0, 3, 3, 12),
            (40, 0, 2, 4, 11, 4, 0, 2, 4, 13), (41, 0, 2, 3, 11, 4, 0, 2, 4, 13), (42, 0, 6, 6, 5, 7, 0, 6, 7, 12), (43, 0, 5, 7, 6, 7, 0, 5, 7, 12),
            (44, -1, 11, 3, 3, 3, -1, 11, 3, 14), (45, 0, 8, 3, 1, 3, 0, 8, 3, 12), (46, 0, 10, 2, 2, 3, 0, 10, 3, 12), (47, -1, 3, 5, 10, 4, -1, 3, 4, 13),
            (48, 0, 3, 7, 9, 7, 0, 3, 7, 12), (49, 1, 3, 4, 9, 7, 0, 3, 7, 12), (50, 0, 3, 6, 9, 7, 0, 3, 7, 12), (51, 0, 3, 6, 9, 7, 0, 3, 7, 12),
            (52, 0, 3, 8, 9, 7, 0, 3, 8, 12), (53, 0, 3, 6, 9, 7, 0, 3, 7, 12), (54, 0, 3, 7, 9, 7, 0, 3, 7, 12), (55, 0, 3, 6, 9, 7, 0, 3, 7, 12),
            (56, 0, 3, 7, 9, 7, 0, 3, 7, 12), (57, 0, 3, 7, 9, 7, 0, 3, 7, 12), (58, 0, 5, 2, 7, 3, 0, 5, 3, 12), (59, 0, 5, 2, 9, 3, 0, 5, 3, 14),
            (60, 1, 5, 5, 7, 7, 0, 5, 7, 12), (61, 0, 6, 6, 4, 7, 0, 6, 7, 12), (62, 1, 5, 5, 7, 7, 0, 5, 7, 12), (63, 0, 3, 6, 9, 6, 0, 3, 6, 12),
            (64, 0, 3, 10, 10, 11, 0, 3, 11, 13), (65, 0, 3, 8, 9, 8, 0, 3, 8, 12), (66, 0, 3, 7, 9, 7, 0, 3, 7, 12), (67, 0, 3, 9, 9, 9, 0, 3, 9, 12),
            (68, 0, 3, 8, 9, 8, 0, 3, 8, 12), (69, 0, 3, 7, 9, 7, 0, 3, 7, 12), (70, 0, 3, 7, 9, 7, 0, 3, 7, 12), (71, 0, 3, 9, 9, 9, 0, 3, 9, 12),
            (72, 0, 3, 8, 9, 9, 0, 3, 9, 12), (73, 0, 3, 2, 9, 3, 0, 3, 3, 12), (74, 0, 3, 6, 9, 7, 0, 3, 7, 12), (75, 0, 3, 8, 9, 7, 0, 3, 8, 12),
            (76, 0, 3, 7, 9, 7, 0, 3, 7, 12), (77, 0, 3, 9, 9, 10, 0, 3, 10, 12), (78, 0, 3, 7, 9, 8, 0, 3, 8, 12), (79, 0, 3, 9, 9, 9, 0, 3, 9, 12),
            (80, 0, 3, 7, 9, 7, 0, 3, 7, 12), (81, 0, 3, 9, 10, 9, 0, 3, 9, 13), (82, 0, 3, 8, 9, 7, 0, 3, 8, 12), (83, 0, 3, 6, 9, 6, 0, 3, 6, 12),
            (84, 0, 3, 8, 9, 8, 0, 3, 8, 12), (85, 0, 3, 7, 9, 8, 0, 3, 8, 12), (86, 0, 3, 8, 9, 7, 0, 3, 8, 12), (87, 0, 3, 12, 9, 11, 0, 3, 12, 12),
            (88, 0, 3, 8, 9, 8, 0, 3, 8, 12), (89, -1, 3, 8, 9, 7, -1, 3, 7, 12), (90, 1, 3, 7, 9, 8, 0, 3, 8, 12), (91, 0, 2, 4, 11, 4, 0, 2, 4, 13),
            (92, -1, 3, 5, 10, 4, -1, 3, 4, 13), (93, 0, 2, 3, 11, 4, 0, 2, 4, 13), (94, 1, 4, 5, 5, 7, 0, 4, 7, 12), (95, 0, 12, 6, 1, 6, 0, 12, 6, 13),
            (96, 0, 3, 3, 2, 4, 0, 3, 4, 12), (97, 0, 5, 7, 7, 7, 0, 5, 7, 12), (98, 0, 3, 7, 9, 7, 0, 3, 7, 12), (99, 0, 5, 7, 7, 7, 0, 5, 7, 12),
            (100, 0, 3, 7, 9, 8, 0, 3, 8, 12), (101, 0, 5, 7, 7, 7, 0, 5, 7, 12), (102, 0, 2, 4, 10, 3, 0, 2, 4, 12), (103, 0, 5, 7, 10, 8, 0, 5, 8, 15),
            (104, 0, 3, 6, 9, 7, 0, 3, 7, 12), (105, 0, 3, 2, 9, 3, 0, 3, 3, 12), (106, 0, 3, 2, 12, 3, 0, 3, 3, 15), (107, 0, 3, 7, 9, 6, 0, 3, 7, 12),
            (108, 0, 3, 3, 9, 3, 0, 3, 3, 12), (109, 0, 5, 10, 7, 11, 0, 5, 11, 12), (110, 0, 5, 6, 7, 7, 0, 5, 7, 12), (111, 0, 5, 7, 7, 7, 0, 5, 7, 12),
            (112, 0, 5, 7, 10, 7, 0, 5, 7, 15), (113, 0, 5, 7, 10, 8, 0, 5, 8, 15), (114, 0, 5, 4, 7, 4, 0, 5, 4, 12), (115, 0, 5, 6, 7, 6, 0, 5, 6, 12),
            (116, -1, 3, 5, 9, 4, -1, 3, 4, 12), (117, 0, 5, 6, 7, 7, 0, 5, 7, 12), (118, 0, 5, 7, 7, 6, 0, 5, 7, 12), (119, 0, 5, 10, 7, 9, 0, 5, 10, 12),
            (120, -1, 5, 7, 7, 6, -1, 5, 6, 12), (121, 0, 5, 7, 10, 6, 0, 5, 7, 15), (122, 1, 5, 6, 7, 7, 0, 5, 7, 12), (123, 1, 2, 3, 11, 4, 0, 2, 4, 13),
            (124, 0, 2, 2, 13, 3, 0, 2, 3, 15), (125, 0, 2, 3, 11, 3, 0, 2, 3, 13), (126, 1, 7, 5, 2, 7, 0, 7, 7, 12),
        ],
    ),
    13: (
        "eNqlWAlck0cWf7khASECjUYQLKi1KIeNB1XriVpREc/17GEVWatVQSgeWy0q3vXGG1upoFipB2qqIuABiAe6lHwJ"
        "QUBEwCBHRUArzL6ZL7S2irq7+SXzfzNvjjdv5h0TDRFrXvraHoNWt0BDetJaUwEAZ6ySRQipoiQsnWK6bANYflN3"
        "504wQJT7QTXYc0+4Wq4rKE62PoQ9ekcMRw58FfBNfwScj84x4T4pWCdt8SSE2CWvdif9iNhrtvzRMSJDns9NUrpS"
        "Tnv6Zh8d+xkO8K1d/GQoka67II8xEcN+h6ZZluTn/QPkx0VOxCXgEazrD+pGr89LvQ8jK+jXrBGX2wH7LFjJo7NB"
        "sTxzMhKnpzqRqeUAE9MFrmTSY1CW9AD4oTQMnA9m63OlACJjmJAN6UBsAVpOEYDMOEfAr9qhqM5QQDgf4c1tStbS"
        "kSh5gRS1s8x9+p036AtvC+EPXQJs9YUPMgF+DAZhRU9wIvbgQSwY0jptZ3zYMjjsM1AU2UDMfAhKAt9y6NlAS6Rj"
        "5mM7cs3bV/toiMxP7BRxlhwKswKbtC+Po9CrR8LSiQACfstmRf0FQjkUnwv4G2/4OUhYpKx2WMJxbW2P4cEDyC5h"
        "EbAYizhXAEUyEhPpUSY4AdicQ+Kz2VgkqnC1L+hELWIfFK9DEfafEbc0zAVJLR74gmvQnrwDMLQGvHG/4EMETfUm"
        "Puw/LVbq5+L4uGI2fsDNRvHK4rVEHGDFZHttIV2fk/eLK6w+ZSHYdhVu4ZQf1bOdL6PSw6AqTywHlPtiOcQ0iG60"
        "rBeWrs8qOI7LBovNOXmpnrD5kFSwTgf7OmHfGjrO/jTdd/hzgwetKaKz3eMQ+9VamqaD9EAC9Ey7nxtlQ3kbeS0O"
        "rGSoLPyS4eE1TMJpWVKKzmXuTNioEo4qv+0LR8LjkocozVrYM5M1/eLLQL8qK2eLNdStEitT9wvcUDPDKt75XgIw"
        "2CQoCAOFdjN4pRYaI9FoQnLzjigh6KKlKC4a8gcCdFzQiky/xm219iBbZLap0Z2JGsCv0vo56n7wQ/h5k0D+yyZw"
        "+PmefoPFMFybK61ga2pDadn3gSWFK0G0HJGHS4LwDrUcmHyHGobEOIJWgtL4HSTpDUfbWpQHgWhneieCWulXJ9F/"
        "LbSM2QAfPa2uv+9u8WCx0CImi/H61skqAkG4WQs+KQYuRgWqWMO97VK4jCJdWOZI0LqHcC5M3N8FN3dJWmobwOmI"
        "ISn0geVqNMaQo3DnG2id6wPvJRuz/UGVYxvLX3V2a1U50FQ3f4bEw55pokI7SrsDtI854bw3QQNVQ7E+LGW1Pd7e"
        "MemRdIeTb1BFfPniYL6lMyVPx7THsmfiXmcEvypQfpvkF3FljAAmMVfR+7r+RneZaTws0L+zSQaD62hj1EHK0dG1"
        "U91ogx8vKC2ZiaFTWnsj9/YqepOmlQXbgHMs9h5U7rHZmLJx6KUdcCNk4zHpdtJjWomKuD/1hqVPZX1+9yDdiRwS"
        "MmGcXkX6P3PvUh8rT5sJ6Ts/STk0NfMkHpRH+XdqkPddRVdw3KYzZq5yZKvtIEMYSkwHohkx4rpHFXW6cDgU8vwR"
        "rZ+4wEaqwU/rCwpKatAPn0PTFBRMgNbPWmPz6gRYcJEO6FJvoyGcLu+8N7vBK/UM+tRRsNgTiTx93X1fWpPvvc/z"
        "njKIPE/HcT/hCXfT5uqT0Bw/NH0MMKqqE1xfSqeOXtOKdKCETO5JrPiTcORbLCyBW0KJU8Ewsgrt+dMSlMovI0+X"
        "8B6aEpfDxXZkJiX69FEn3sR2xfM4kpcCej3jcZyRx7gdFCXzitVULuMPjnQe/Ox/he8EM2/Ya3jaNw93b4bHewTo"
        "eITL5Zajt/QoHQPgloOu5+pyyuivlatIR/Pd9CTWGFY5Y7moDelEG4bh+GwW6zYhNfjxWIyz1+mc/VMKdAcGmQMR"
        "aN5AUAEL3rZzs99mt/cnWLzHwJ1YwofPhRYVIyDyOtprtuGqB9/LpXAERZVhGq3bZM2n/a0vrWTDzxZJGG65tYuf"
        "zqV8Hj/7wKcf8+ODq93fTpJXQSl+0jTkIc11HJ7TPeWiX4VAjpJrdyJ5PpKS3bGHfWUftmnjAJgRy+9/RRRo/XnS"
        "vczBJDNr5U5MdJMGw9EWGVkgNSszfY6ZGFCqMPc6s8hMeFcozeMOR5qJDtXDzarek24mHOto+XFa0YNEDFz+5YNA"
        "GFjZAfTz6J4OxjoSV0qMM3kRBXNajY6E+aVxD4FbQIkfD8HIR74gDMJRMCztfslpehaczpDoxhaIuMagdz0F8bYk"
        "el0MP6pff59RnuKT7zfJU/5ukzw/NMlT2iRPw0vyRJvlMbZm8tSQQrODFnT0o4vnJ3XhF4r4N4996hlKdh5kxlZ9"
        "XczqyrwxPP+7TTzOPsFjD5MMPLTZxh2W0tLhoDj3XQeCGU23cInuyugWNKIvy6qPa0VXbJecNG4+zSZqfZ4MAdGW"
        "s+CXrtd/7zCBBXW06hf3/P8Qb2l6PPGBmcAsGD0q+FcCJB2UQ6uMzQB2uwx67lspBGXQyV2e2tk/o7lH6AkM9HQn"
        "18djEncF4N1qjPc2dWoIZ1Hh+By4RVMlmJjSvphFN8VvWzfwEsY1eGMZqWWZzwcA8meuA39DG8niQjDbygOLuq5g"
        "X/FFIsCK7QAXvoJxx5x+E8PlkQCL4mHnLMjtYVmDjqtHKRhcYdfXg2haKarqnwcwXrsinC2fjNbl8DijK63MJaOx"
        "vP0QE9r2VTQQx+6jWaMIRhsxMgivhNgX92SZ+qML/zJLWMfyMuhVcGQPReu8oTaFATSs7MWzM6lh9D16rpvOCZxr"
        "NHSTeTJYflUAFgWjcDv3pkE4zW1hwgO3Cnc2UYppMz/zQGL3+oNbS31nPYthvUpptGyR789uMXUXMIWT01Mw0X2J"
        "rixkSeoFlqg/L6YDl3iWcwF0ojf9aD9BOj2YDX2x6BZF50ijAqyk4b0zO8TLNKwvpcu70WcYzFiCkQLeYnrWT8zR"
        "+zE5OBlnvWQTMhl8d4DyCmjRinf7soTxtNskEJxwhnZJOgOuciocJt1DPShV4xoFMJOLP0nEdo2e0BsdM4anrZj8"
        "R5T9upy85CpmZhfuttSQXSLFNcyZ0R9MKtLQd2AvzBbwoTHBoCFRQuuMUA1ZlmuIEIPlRl3uAWvYe0Qiid+naMRo"
        "2Hby+7z7UNLYqP4ItDEi6fH1oDpyV79NBn9Ptm3253JrEOMOiaySidiKDhpJxGyOHkRsTzAsjUX+hQMCygd1YsGt"
        "hfR5t0OnWyKA7w+IFJnjrRoxoQo8+j61+7unlfRJ49IZzkaAVVogqI7quW8E0Dmsv13tV+5diQRyCDetOZVDiz25"
        "Bgwl6HuZQGxPbxIolIggGfv5lwLE7xbKL+INa/Xz3fzd1n99WDCcevvuNQ3iCTms0dMXPWZcRKihb1v0G01Pqb+j"
        "Mhaai/KgjP3z2jf/E0FALaifbnhFXOhn6ong9aAP1jrmD6CN+YmMNyVvOevSqfJz1tO3bmgzOYalqvCshqzhioav"
        "198bjp1DIfjJQgi7B/Tm+OCvFxHQu8T/xC8I1xz5gqYi315TII3I0Wfhwzwq1Q7a509XNKBjhOm6TjRDw4DE17/Q"
        "NfH5/p//95f/1fH1f73QL71Cm447vBhT+63UWahf/fCGmTnGZDd147sQddGhPrSFtCX0OVuT0N62DSj36ftVu8AU"
        "E8zPvXt7MKiXCflBbTBGDnzlbF4EH2GWt0q8m9Mv/58KXheCjnsGEdvWBYL9DWz054yZIUR8g/4PcXH2nFQAVW1L"
        "u3pH+Gc8wLH5kIzvLf8M1X2MT5Ky9etYatyATv1XfNJoTQLQVEtXngJJsd4TFsVCt8eSD09uXQDJEwCK+i6e55+o"
        "eIwLbl9x3sOmctQZHOybVSCAjMxA+oKqPAywqpE6+Zg4GhAFYFvk51lKY7BvwY2xTJvpHIPx1zJmIKhLPbo8agcC"
        "LSaw36YIb9Ek6Nqs4EuYttW3bP1MBXN/wtdWICSjO/1E61CG+a111cJtLKbVdGcxSUdL4VEqgPfdXTQCRKEDek4j"
        "zuQSTFI6V/VBf2KgvjuB/g0WlkOfT8/LsFO47FiyF7Hj1TmqSlAShC8uAV/1Ikrkvj6h/+NrfXctRvoG4R+G7kpc"
        "AHaeY9jUNrBBSPstM0R3njArXjI2OaXNfwABYq1X"
        ,
        [
            (32, 0, 0, 0, 0, 3, 0, 13, 3, 13), (33, 0, 4, 3, 9, 3, 0, 4, 3, 13), (34, 0, 4, 5, 3, 5, 0, 4, 5, 13), (35, 0, 4, 7, 9, 8, 0, 4, 8, 13),
            (36, 0, 3, 7, 11, 8, 0, 3, 8, 14), (37, 0, 4, 9, 9, 10, 0, 4, 10, 13), (38, 0, 4, 9, 9, 9, 0, 4, 9, 13), (39, 0, 4, 3, 3, 3, 0, 4, 3, 13),
            (40, 0, 3, 4, 11, 4, 0, 3, 4, 14), (41, 0, 3, 3, 11, 4, 0, 3, 4, 14), (42, 0, 7, 7, 6, 7, 0, 7, 7, 13), (43, 1, 6, 7, 6, 8, 0, 6, 8, 13),
            (44, -1, 12, 3, 3, 3, -1, 12, 3, 15), (45, 0, 9, 4, 1, 4, 0, 9, 4, 13), (46, 0, 11, 2, 2, 3, 0, 11, 3, 13), (47, -1, 4, 5, 10, 4, -1, 4, 4, 14),
            (48, 0, 4, 8, 9, 8, 0, 4, 8, 13), (49, 1, 4, 5, 9, 8, 0, 4, 8, 13), (50, 0, 4, 7, 9, 8, 0, 4, 8, 13), (51, 0, 4, 7, 9, 8, 0, 4, 8, 13),
            (52, 0, 4, 8, 9, 8, 0, 4, 8, 13), (53, 0, 4, 7, 9, 8, 0, 4, 8, 13), (54, 0, 4, 7, 9, 8, 0, 4, 8, 13), (55, 0, 4, 7, 9, 8, 0, 4, 8, 13),
            (56, 0, 4, 7, 9, 8, 0, 4, 8, 13), (57, 0, 4, 7, 9, 8, 0, 4, 8, 13), (58, 0, 6, 2, 7, 3, 0, 6, 3, 13), (59, -1, 6, 3, 9, 3, -1, 6, 3, 15),
            (60, 1, 6, 5, 7, 7, 0, 6, 7, 13), (61, 1, 7, 6, 4, 8, 0, 7, 8, 13), (62, 1, 6, 5, 7, 7, 0, 6, 7, 13), (63, 0, 4, 6, 9, 7, 0, 4, 7, 13),
            (64, 0, 4, 11, 10, 12, 0, 4, 12, 14), (65, 0, 4, 9, 9, 8, 0, 4, 9, 13), (66, 0, 4, 7, 9, 8, 0, 4, 8, 13), (67, 0, 4, 9, 9, 9, 0, 4, 9, 13),
            (68, 0, 4, 8, 9, 9, 0, 4, 9, 13), (69, 0, 4, 7, 9, 7, 0, 4, 7, 13), (70, 0, 4, 7, 9, 7, 0, 4, 7, 13), (71, 0, 4, 10, 9, 10, 0, 4, 10, 13),
            (72, 0, 4, 9, 9, 9, 0, 4, 9, 13), (73, 0, 4, 3, 9, 3, 0, 4, 3, 13), (74, 0, 4, 7, 9, 7, 0, 4, 7, 13), (75, 0, 4, 8, 9, 8, 0, 4, 8, 13),
            (76, 0, 4, 7, 9, 7, 0, 4, 7, 13), (77, 0, 4, 11, 9, 11, 0, 4, 11, 13), (78, 0, 4, 9, 9, 9, 0, 4, 9, 13), (79, 0, 4, 9, 9, 10, 0, 4, 10, 13),
            (80, 0, 4, 7, 9, 8, 0, 4, 8, 13), (81, 0, 4, 9, 10, 10, 0, 4, 10, 14), (82, 0, 4, 8, 9, 8, 0, 4, 8, 13), (83, 0, 4, 7, 9, 8, 0, 4, 8, 13),
            (84, 0, 4, 9, 9, 8, 0, 4, 9, 13), (85, 0, 4, 9, 9, 9, 0, 4, 9, 13), (86, 0, 4, 9, 9, 8, 0, 4, 9, 13), (87, 0, 4, 13, 9, 12, 0, 4, 13, 13),
            (88, 0, 4, 9, 9, 8, 0, 4, 9, 13), (89, 0, 4, 9, 9, 8, 0, 4, 9, 13), (90, 1, 4, 7, 9, 8, 0, 4, 8, 13), (91, 0, 3, 4, 11, 4, 0, 3, 4, 14),
            (92, -1, 4, 5, 10, 4, -1, 4, 4, 14), (93, 0, 3, 4, 11, 4, 0, 3, 4, 14), (94, 1, 5, 6, 5, 8, 0, 5, 8, 13), (95, 0, 13, 6, 1, 7, 0, 13, 7, 14),
            (96, 0, 4, 3, 2, 4, 0, 4, 4, 13), (97, 0, 6, 7, 7, 7, 0, 6, 7, 13), (98, 0, 4, 7, 9, 8, 0, 4, 8, 13), (99, 0, 6, 7, 7, 7, 0, 6, 7, 13),
            (100, 0, 4, 8, 9, 8, 0, 4, 8, 13), (101, 0, 6, 7, 7, 7, 0, 6, 7, 13), (102, 0, 3, 4, 10, 4, 0, 3, 4, 13), (103, 0, 6, 8, 10, 8, 0, 6, 8, 16),
            (104, 0, 4, 8, 9, 8, 0, 4, 8, 13), (105, 0, 4, 3, 9, 3, 0, 4, 3, 13), (106, -1, 4, 4, 12, 3, -1, 4, 3, 16), (107, 0, 4, 7, 9, 7, 0, 4, 7, 13),
            (108, 0, 4, 3, 9, 3, 0, 4, 3, 13), (109, 0, 6, 11, 7, 11, 0, 6, 11, 13), (110, 0, 6, 8, 7, 8, 0, 6, 8, 13), (111, 0, 6, 8, 7, 9, 0, 6, 9, 13),
            (112, 0, 6, 7, 10, 8, 0, 6, 8, 16), (113, 0, 6, 8, 10, 8, 0, 6, 8, 16), (114, 0, 6, 5, 7, 4, 0, 6, 5, 13), (115, 0, 6, 6, 7, 7, 0, 6, 7, 13),
            (116, -1, 4, 5, 9, 4, -1, 4, 4, 13), (117, 0, 6, 8, 7, 8, 0, 6, 8, 13), (118, 0, 6, 7, 7, 7, 0, 6, 7, 13), (119, 0, 6, 11, 7, 10, 0, 6, 11, 13),
            (120, -1, 6, 8, 7, 6, -1, 6, 7, 13), (121, 0, 6, 7, 10, 7, 0, 6, 7, 16), (122, 1, 6, 6, 7, 7, 0, 6, 7, 13), (123, 1, 3, 3, 11, 4, 0, 3, 4, 14),
            (124, 0, 3, 3, 13, 3, 0, 3, 3, 16), (125, -1, 3, 4, 11, 4, -1, 3, 4, 14), (126, 1, 8, 6, 2, 8, 0, 8, 8, 13),
        ],
    ),
    14: (
        "eNqtWAdYVNcSnq3sAsKiCBZUgpTYUCPSTJRYwRYVMbEQFE0MJjHGrsQYRZ8tRqI+S6JGY4kmKoIVIrZIRNQgRRQU"
        "FBCQsvSFZV04b+bcS8T3Io9X7rd757/nnDt3zpyZOTPHh2l8/uUHAO0vgX2W1IeNo4aXbti59L1ZnyCBkw7fuRNN"
        "hJtKgNDUyuTqu50Axqzt/x01rxw/OwRApq+vM9ZF0TBJnBmSdudM4ql73ErPnUTB/isVEWkIG2WCdH8RS73XATqz"
        "ecwq6ifwZJOYpv8CaGs4xD8O843ssh9nwPYbP0eKEoeWQUQ80tEG+VzjQtYz9gQov69kJTsshH4avro0bzLARwlS"
        "cGFvzq2W2hT3BYSD5ldJD22hAatKciYPyW0FwmWSPkFE8NWZaemJAwg5lbrphy9+SPDXJe6s7XCGEk9NVdg8Hx2a"
        "DaApeBNgTvGT4QCOR/Nr8nCYKne7RtIGwRvMDqDtRAWYZX9pKshkn8UMBqaPgfPXXCXU4sS6CeL2YV0FYFJw0EYy"
        "hga7RhToy++YwcsL1XUkSOI8YMwfAKdXgLxqBPJwBC9mjSw6QlvWByA9CGDtQYAOz1D78xfNMEcloOJNK7vgCoYB"
        "LLsBEKADGMbUMLpeCsFPAcKPAqQEgGuWDA4NgUYdWsuQmJkH3TzCdiegPs7d+xt2hZwwTfRGJVlCtw9eaLspuarH"
        "Weq3/WUfhKbBg9n9tabr9PrpgtVRX7Qz3iwTCU4Lo/sJXCxQp/J130z3H1HVIE+j0cN2UcMO1DpI7ikIS77I1qdN"
        "QbBE66MONPiC9NlifDoaDV0ZMQquAG/WAcEoph7A2gugK2mLuoTBP0XT6wPV0/B1ZJhTd58Y9olr0Cyo/oVp1nfj"
        "8v/728yHlbEOMOyJk8XFODiwDGBsvbKfLUBQGUmqTF5LZG88ehCsyLTB+4y81/DuW9iTOqqMerwswTmiqPycI6hz"
        "wkw1P98F15MSgHcaaLKS7jfiaGQsu2vL/aj77fXg8Toi/xrp5l+QTjYq3QzTzXul4ar6p9RkrVZzs97P9R9YSsSl"
        "8EMkqqRgknj3IRJ8Uro5Ea1BT8sHf7m0j+pQuJMgqbPjHDvWSjj1frCz9MkWNUxp+NTELXc7uE3Hxrk6iQW5ox+z"
        "XnUZ6SeVst6GD8y883B9xyfp0ufSUg64rsv7FsXzzBmqcEzai7ZDkeaNhWDRMO16RepnUvSjq/1Uw4uXwptsKHYt"
        "KgBXvoAjmcpERy0L0O2+SeutGKH9CECxIU/3RwAAKVFvrOTS3fiK7mNLSBhp8kJuY3mkEsWjEHoIySK1qvPfp4fF"
        "90gsS60QDDyvlBcd7QAW5etVrSOvgRv59Jh6hSpjg6lNZApAXx1jGfYgTT2msbu5En3QEWBitbQbubO/Xi5/cKiV"
        "bRzGQqczZYX7MCq0P1pSslkGkvhjlp0SF4EzjQtIhV7MCWCSUabIPKLpcoWZQ49L5bcWMrnaB60kOBfUxkEAe34E"
        "OBVt5lWGdmJ7uurecAooUnShppfoUfT/p54/rwkoz/EgsKiy4o8SWkrfO8HgfulkDzh+wQ0fU7e0JWf7KCPMEqnp"
        "F49H00hr93Su1qbMhJbOHGduprinXvhouSnSVl/eH4Zk6K1A8Iw94QxRVzzI7YTXuhwv0kZ0BnnqIUtNxA1wKbHH"
        "BeXWjbErgRPfgu5EvFKd+WOCg/BmL4HYxoqMMqUC6Lz1kS5nJ3eIMaXruyp7n89Bf++tm3KwIiF8RCLGwwv7995s"
        "N7Oh55xK0Bgn1Q+GQWUSP6Zyw03OFhadg5n54MHeqvexy9lqnbIcrBtGz8s4Hfjw9ucyDP7XBXunm2PhMRdpl9VX"
        "eIvdnvzquwtVggxj2M8COLxLRyoA0/L2dycSeDcalh0jcCoQHKqxz1JfVlLCsG9GjJ2d3Qbsi/kYu92q1TZGe1qV"
        "Av9P7nFe+475MH1t5YXuggea708TPdKPKTloc/Qutej1DVniJiLrff5t0WsnFUkE4K+XCRvIncN8cO2TDSRi5wNF"
        "VSmf4gy7FIS3VQzKxgAfeYGrv1ZtWc+3Xdlsa3dmL66355+oLfMlYvaROVw9SyiwSAJ9qje1VvoWz6bAeaai7GYA"
        "l6y2+u4qtSCa1ONSUhtRNmX6jsbYMr+wEY1mKhH5M4WIVmSIvea5y4UJDrp5TSlwvhdqIsweLwdxPPwrpe4oeHV/"
        "03H6YS3jt6UF/DSitjr/WFSVHCIlPa+2UE2pw5AUeZI6NlYpLeuHc9ed2MqddWmq5zB9ndHSlo2ghgBk9TtlVfAD"
        "Ig/9GguLhQnE3vuyruyH0Y15nE9LAU3A0OK3mvm1SAFNqMN6Fac9aa7+z5WKzB1q2+sxAD0uVjw73E4cuu83wQzW"
        "plrxljk5dvytCcXdOZsxlQMEfkV1gQIYN6fWTfzSwVxbAZim/KYQGDpV7IL/Qth/orYqvDBL5pevD9Oi40AHRnoo"
        "eAvhrKcED6xHGLGH4HuYwCjLJxK0rbaHoXGCzk5+DFuWCjDoPGT0EKB1de/MRsVfiw1vhAvYYAFmy8XleBgogtkp"
        "EgG0eTRKHB5yTQSqZ14ig+WnRKApDxGXbNNDEXSoo7vj4cLaJ+G0H3Qr/ba9xOVsGmbFF0/zfOXJRmjTwA0UlmRj"
        "hBT8fzxTNoaCCUzZpoHbKCzFnPjiGeG1DcQsvB04n0mjjRc/oc8Oby3Eg4pfbLhWLc6eFbQ71iBEp3cEahUdxX2s"
        "6kTbFvgWSf94s+aF9ElmL6QPeyF9ZhPpFS+kN2kqfYwo/RpMkbRc+qsUJrseLHzOWMkKifhJRf9AIQg82ytGs9fi"
        "xanAhOdyAQRUC7HX8Y9QPtjAToliDzaMFAfHfC2CTY3RaVSZGX61NO9rBZg8DlW4PFoFfSl1nXkZ2htFAWZW5W7t"
        "TaDVlDPPgwWR1pXAumgKoAZ5P8NStc25CEyU4yoKdmuAu7qwcf/vPtCY6rY81IhgIMPVh7eZRUdGqfycYgmcveUi"
        "887HhFizNVuXsUwOwfl8gltPWxm8aBd8OgXOb6QEU2cOwVSGfYMpbWsDJgFP3sGnC1+CeznVkMGJsHEfvdna8Frm"
        "MC7phR8LZYKy2Ha8r3lAlSejnKgHaz8YCyaYkV+L6VVIKqj0YwAOrNCiWEewMryC/pvtGREKkDsSq9pr4FAh/ywG"
        "XjOgWQ2sVQRHgWu1POgq2UmNx8G5ICnx3PMFLxHn5/TAymVJBmU6sDyxAO+f3injYnixw3jvySjod66irdNFNxA+"
        "zVKD9PrXmJf+vh7m3qM8onv1mLJ+XPCVDV8JS7u9Zj+nQ4tcteMoO82ZClOLsHQ4QBvvqQgYV9mJCm3t9Fla0nHP"
        "532lSeEIzuJ7QwzO4KOjzOV0FCRwji6GnXlmnONWNh1e9qZXASGhZrxSTuX118ZkyqG9KrtR0pfBrfDbI/yFDKqp"
        "zR/wWez+jDMRNlT9IKM+jPi19E/jxRKPl3ti6SeUgUJJKJaHQqkolI1iCalJFAzB5Rxuo/AffJaPhwPkTa0TfsH8"
        "c/68kd+AJMValqoeggXWuhnHMTNySvDjc/Kzm4ODB4P57oKqG+44499tTXZkYLzBHWoI1tiqmQd+TWaWsvhrfo5T"
        "maYf1QhTmMau/kOp0y3WDmY8rkkNYd2bXYGRt2uyFxC47aEcWx2EgOqTTWkIKPce9xxTJcp9xzUgIOPakIRdKf2U"
        "E6onIpj1sDbJn6qflXmVMVgprkzvrtryWK2qQWtS/fpGL9aJf6ePmH5Y1I/H9fuhE+xLczLblSwB0+15pSc7QXMW"
        "IlmYVZO8FMHfcryVo4qYxqz2PexaxjT9OVdfpunLQ+5YpmllmErnMzh4W3Y/5dhsqkS3FVfFTKfUbt0z7XGcStjF"
        "juptsaCuQfMyN9r14gb03KuPKKqFEWfZI9sU9t7p1Pr8AYyEP1QU7SSj/qYiEl5n/dFVkZsZxr3vW1Czg+TzzNrU"
        "RYjCRPFNa0Tx3Vos/ixmCr95U6WLFenBGw6yt/IxhljseKq7P1/WTEQNSKm+0RNpgnOrc4lIJ+E+SFmwPXVa+jCr"
        "F3H0L6jNaejySNpMpgY4Aro8lP751eb/FopFBtnA2nXNbgGatO+IKmJP8ontu8yT8E3pwvFbjt6bU+cNhZ35eGl0"
        "Ej/IAqvMCEkzueQg1tUmu9KHhZblDltWnuuH7+xSfV+4V/VdDkIPrPk98W/qw9rjPkJ/yyaytwD6JwuavuliHvWf"
        "axpkq3P1DyjQrcrxNJmgGw9qHR0RbfoDC3iyjXF1sl7cWsbXyVQ6MpJNd2iwh8l4HAyysKd16TP/f+7cTMT4v7nj"
        "qz3eh31YNtiHXXHEhzepxfqvPQumP668YAcdjX7msZEYYtzA5V2QRlbt5Qn8kP2GMHBHnc4yyL2Nw6SrCwE+yNLd"
        "GSQeExOLgejEn7zadQcwTAdMb9VNetW6cfo2WZcVHSJrPCgCh6FKqnaYeGVhp+99XfxnTHOXNsfxRfLFKbS3bIdO"
        "DU4gL0VTvrYEhj6W0Fky/J1OQNvUdc7jh3Vnfkrm6pjMluL9PuYNQex9VOXVTTcB9mTtBbi+2MdoARkfPMJQ1F1e"
        "Nsq2QFXbwfcxwLGvA36GK5M3bsPC+c7Wj2HVztu40NaGzF4wOLuScprftRJQ10Ui+vkiwOu1XmCjnQQXabd7/+ms"
        "h/xM73z9W/wIME7Pz6vm3Xo3H+fqUNUfoveA5NJu3KVqBx+kVLi/sZ2f3hwLqhiQF2JZnhaEecURcKnBvdqrQrn0"
        "KL2fNSKen/SsiSrie2439nc+P3kFz2ikXwiHHjXXhQMfnldSeyy9vaaoLdpVw7uY35RglqOM17ajBIPKM8ajNygj"
        "izEF7/1SwFmglVrppwF8rpW91O7JXMHkTDEawb+tQP/8OZeicqY1qF5i5NgwGHfsLOha//ZL7VMb1M5l4SD7tWRf"
        "v3l6uWtJH9f92WvhHyWaI/M="
        ,
        [
            (32, 0, 0, 0, 0, 3, 0, 14, 3, 14), (33, 0, 4, 3, 10, 3, 0, 4, 3, 14), (34, 1, 3, 5, 4, 6, 0, 3, 6, 14), (35, 0, 4, 8, 10, 8, 0, 4, 8, 14),
            (36, 1, 2, 8, 13, 9, 0, 2, 9, 15), (37, 0, 4, 11, 10, 11, 0, 4, 11, 14), (38, 0, 4, 9, 10, 9, 0, 4, 9, 14), (39, 0, 3, 3, 4, 3, 0, 3, 3, 14),
            (40, 1, 2, 4, 13, 5, 0, 2, 5, 15), (41, 0, 2, 4, 13, 5, 0, 2, 5, 15), (42, 1, 7, 7, 6, 9, 0, 7, 9, 14), (43, 1, 6, 7, 7, 9, 0, 6, 9, 14),
            (44, -1, 13, 3, 3, 3, -1, 13, 3, 16), (45, 0, 9, 4, 1, 4, 0, 9, 4, 14), (46, 0, 12, 3, 2, 3, 0, 12, 3, 14), (47, -1, 3, 6, 11, 4, -1, 3, 5, 14),
            (48, 0, 4, 9, 10, 8, 0, 4, 9, 14), (49, 2, 4, 5, 10, 8, 0, 4, 8, 14), (50, 1, 4, 7, 10, 8, 0, 4, 8, 14), (51, 0, 4, 8, 10, 8, 0, 4, 8, 14),
            (52, 1, 4, 7, 10, 8, 0, 4, 8, 14), (53, 0, 4, 8, 10, 8, 0, 4, 8, 14), (54, 0, 4, 9, 10, 8, 0, 4, 9, 14), (55, 1, 4, 7, 10, 8, 0, 4, 8, 14),
            (56, 0, 4, 8, 10, 8, 0, 4, 8, 14), (57, 0, 4, 8, 10, 8, 0, 4, 8, 14), (58, 0, 6, 3, 8, 3, 0, 6, 3, 14), (59, -1, 6, 4, 10, 3, -1, 6, 3, 16),
            (60, 1, 6, 6, 8, 8, 0, 6, 8, 14), (61, 1, 7, 6, 4, 8, 0, 7, 8, 14), (62, 1, 6, 6, 8, 8, 0, 6, 8, 14), (63, 0, 4, 8, 10, 8, 0, 4, 8, 14),
            (64, 0, 5, 12, 11, 12, 0, 5, 12, 16), (65, 0, 4, 9, 10, 9, 0, 4, 9, 14), (66, 1, 4, 9, 10, 10, 0, 4, 10, 14), (67, 0, 4, 10, 10, 10, 0, 4, 10, 14),
            (68, 1, 4, 10, 10, 11, 0, 4, 11, 14), (69, 1, 4, 8, 10, 9, 0, 4, 9, 14), (70, 1, 4, 8, 10, 8, 0, 4, 9, 14), (71, 0, 4, 10, 10, 10, 0, 4, 10, 14),
            (72, 1, 4, 9, 10, 10, 0, 4, 10, 14), (73, 1, 4, 3, 10, 4, 0, 4, 4, 14), (74, 0, 4, 8, 10, 8, 0, 4, 8, 14), (75, 1, 4, 9, 10, 9, 0, 4, 10, 14),
            (76, 1, 4, 8, 10, 9, 0, 4, 9, 14), (77, 1, 4, 11, 10, 12, 0, 4, 12, 14), (78, 1, 4, 9, 10, 10, 0, 4, 10, 14), (79, 0, 4, 11, 10, 11, 0, 4, 11, 14),
            (80, 1, 4, 8, 10, 9, 0, 4, 9, 14), (81, 0, 4, 11, 11, 11, 0, 4, 11, 15), (82, 1, 4, 9, 10, 10, 0, 4, 10, 14), (83, 0, 4, 8, 10, 8, 0, 4, 8, 14),
            (84, 1, 4, 8, 10, 9, 0, 4, 9, 14), (85, 1, 4, 9, 10, 10, 0, 4, 10, 14), (86, 0, 4, 9, 10, 9, 0, 4, 9, 14), (87, 0, 4, 14, 10, 13, 0, 4, 14, 14),
            (88, 0, 4, 9, 10, 9, 0, 4, 9, 14), (89, 0, 4, 9, 10, 8, 0, 4, 9, 14), (90, 1, 4, 7, 10, 9, 0, 4, 9, 14), (91, 1, 2, 4, 13, 5, 0, 2, 5, 15),
            (92, -1, 3, 6, 11, 4, -1, 3, 5, 14), (93, 0, 2, 4, 13, 4, 0, 2, 4, 15), (94, 1, 5, 6, 6, 8, 0, 5, 8, 14), (95, 0, 14, 7, 1, 7, 0, 14, 7, 15),
            (96, 0, 3, 3, 2, 4, 0, 3, 4, 14), (97, 0, 6, 8, 8, 8, 0, 6, 8, 14), (98, 0, 3, 9, 11, 9, 0, 3, 9, 14), (99, 0, 6, 8, 8, 8, 0, 6, 8, 14),
            (100, 0, 3, 9, 11, 9, 0, 3, 9, 14), (101, 0, 6, 8, 8, 8, 0, 6, 8, 14), (102, -1, 3, 5, 11, 4, -1, 3, 4, 14), (103, 0, 6, 9, 11, 9, 0, 6, 9, 17),
            (104, 0, 3, 8, 11, 8, 0, 3, 8, 14), (105, 0, 3, 3, 11, 3, 0, 3, 3, 14), (106, -1, 3, 4, 14, 3, -1, 3, 3, 17), (107, 0, 3, 8, 11, 7, 0, 3, 8, 14),
            (108, 0, 3, 3, 11, 3, 0, 3, 3, 14), (109, 0, 6, 11, 8, 11, 0, 6, 11, 14), (110, 0, 6, 8, 8, 8, 0, 6, 8, 14), (111, 0, 6, 9, 8, 9, 0, 6, 9, 14),
            (112, 0, 6, 9, 11, 9, 0, 6, 9, 17), (113, 0, 6, 9, 11, 9, 0, 6, 9, 17), (114, 0, 6, 5, 8, 4, 0, 6, 5, 14), (115, 0, 6, 7, 8, 7, 0, 6, 7, 14),
            (116, 0, 4, 5, 10, 5, 0, 4, 5, 14), (117, 0, 6, 8, 8, 8, 0, 6, 8, 14), (118, 0, 6, 8, 8, 7, 0, 6, 8, 14), (119, 0, 6, 11, 8, 11, 0, 6, 11, 14),
            (120, -1, 6, 8, 8, 7, -1, 6, 7, 14), (121, 0, 6, 8, 11, 7, 0, 6, 8, 17), (122, 1, 6, 6, 8, 8, 0, 6, 8, 14), (123, 0, 2, 4, 13, 4, 0, 2, 4, 15),
            (124, 1, 2, 3, 15, 4, 0, 2, 4, 17), (125, 0, 2, 4, 13, 5, 0, 2, 5, 15), (126, 0, 9, 8, 2, 8, 0, 9, 8, 14),
        ],
    ),
    15: (
        "eNqtWAdclFcSn60sVaRJWTBEmqhJBHsjgC0EC8qJBQMYWwpBPH7qWSIGYzcQo4fYS1BPT+MZo0JMVDSAggpSpBhc"
        "ikgXVpZd2r6b975v4Uyiwbv7frtv/t9789rMmzcznz+R+//uBwB9b4rcyqX+ZCmteKEAGHZC/BBZIj8dcgrJWY/P"
        "PoOlWZrsZ0VbQJ4K+VKAgFiL2wB1HW1tHRoPuOy8JgxAWIQAYPBZYSGwxyXahJLea8hEJAuVueRZENi1B/uT2Ezw"
        "Im7+ZPJqMG/67hO2oLE5hHxnRjssJOUXKPUnMVrZRYXQn4QT0zlkVyg5VAQQmq0mZaO4dtpva0PlAgBjRbIAPMjk"
        "VW0y2FtrA4j9VrfJxmunUM4tdRVhxoo9oHsScvV1cLx6eZriijuFxoqY5nDhQbb6hEvexAn+QkyR46mVjSZKelxB"
        "OSYDTC9oTvcEsNlW0NT8CFlNys86C8XmiLzJACytA/XB5Ne9NvwCrTJJp6aNoJh+KPQ3ZXVvkTH88n2IJ4+Ma68N"
        "kojm0h5uCY+UrXWZ5vCiymzmAyTPAr8KIVyOA5l6FrxD3oEJxBHGEDdwIF4AJZEAm5IA+jQif2jCZxJ83QRgq7YD"
        "uBEDsPkuQFiHEAKIBcwhBrCsDuDYGRA9nQF+uUJI8egSqzUlYotNqadIwp0QEKfnJFA5HpXdDgLxDhnI13Vr4DdU"
        "pKHb1dx9WTvE5+g3Bn/wWLxeo9nf95bIrUJK29b+lZYP7LFwv0VhTDgtH1pj4fEThdsWYyEoppIeeYlWfB2ChbCk"
        "F8XC6DLNQ/q+odFXf0HHdJA8i8a3f92Ct5m0w1vFE4kLgiBiOYk4c6CrSdLIM2N3b/0w7I4DlreyAQUhhUTueLfm"
        "JJH7fGnCbaGn5ZhrDdUnrGFgy0d6jlkpEEs3FkxMPAciXa4U0YXLq9dQYlOQKEDyxqPjtLZ/xS765lEbzeTWhPLE"
        "xw7G/lz/7KILuKsWSy1/KIR5e7FxHj2kIBx0N5Oy3ibpVpSK3s7dCf62iELbZVnrkS4mpssa3zMYWnIeBKseqYvX"
        "czZwmtPNkgZGB1Z9TKlB3hy2iQMH2DZm5xswWt/G6faluh/LFnoaIOQ+b1/Rp3hw7OhPTYXReCJvVXlJxzdswymp"
        "Fa97LhBYYy3amoWg5iMEaxpFEFs50mBywwoAvW2Klqxg2n/cL6rKPUYAXk8nSVwLTgJkrKAHYS1Yk5CfG/NXiGAc"
        "+WWozK8xBiaTaXRmJYxiip5FLIxbac3nDSKILx4s8WuKApBuf6K6jyMzyXYo2RrTmLin1tF7S/ggir4EP6Fikjyi"
        "K4OPSuhK9Ss/oC8r8oRY9qqfwboO+mel6nGsBfRuSLQVuKZm4AU3gCnb3LA4US5yTy8UgHsD0ZLcviB+mOIiHV6y"
        "EUaTocizqFU2hgxhF5+ptCTFSTi4GG3Y4UC5qnijMc6wvURd9Cku6E5af9GYisUwgjEvzoNhZBiCpVoDaf5NF8no"
        "HGIN9scrnl2IJMaG7xpi08oqMOqg0ru2DyCx2EUSWYtKMo6vUn6PpoCGh+YH//Hw1kj/v2npesKuAKSEgpO6F/fu"
        "iH+nQwXgeiw7WHQiPQCPbc5+Jyq/WVmn3qbmE5h1kTIKAn5hol774nh8pSN7KTlEe0o+zD/mSkcIyjxBZ4jPgf7H"
        "7s0Snr0fiKPTGWjt2dr6C/1Ar+iMae9LOTC4zp0qmlvUV3mMTKkbzA5OwQD2mtOfEYEnv9eb3AbRC3IVxpE365tz"
        "NhhRPKIsyVff9L2ch2hLbk0bep1UpsdNLkwEuJwCJwqd3Dvsl6klVp2z7bSBICqAGcR8HHGjHmPUQYhowmvd2YVM"
        "N7m+0qZoI9iR2bDy1+/mFd5fIQa48sCAzeZAC7viu5P0pUP2XeIWEJ2rqk2eJ+SWY6put+TQktSMcA6lfhiRzoDz"
        "cyOrdior+PIAwCVq3oLS5rq6FnSQ4Fspl8tdWoejzdH7AZJ2gVHzZHZ+q8WhTWy7tlo/f6JRqyu/deQs1/7SQ96U"
        "g0hvCoT9fs4XII+mk+Q5sCaRR8F5nmcBMebAB1oDBpwfXATKrC6Lo8Zj+bWiRXHsTZxHcc5J0PdotT1cuC9kVrXT"
        "SjuX7WHUVB8yiD8FvuQtHjmQOYz6jIdfMqmqpeVRMKgx0UHgfP4hqtflZE1LUawlnUzdnB1jyF08wpE38vrwa5Mp"
        "jugupXVKIY9mEwsehRBTHm15wvOZ1mzkNvjuvXR9NrI673MZsA3hs/mP3VhXe5+Xt7/Ad65n49XBn48n56Vl/MVD"
        "VU1KICKL/Iv9BVbryUqAM7li2nakxdBSG8wJNdDMu0vCKGxql1Wa1g47e8IxLMQRbzxgBpGM0K3ugqvA8fAtOo/j"
        "kcrWspjpurgR/F8Hsf22vVbfV/x6JJT/oG5bTBgdQdyp3k0MKg4ZWGegDx58XVl9yo5nfU85iQEf5TRWM7opiPUa"
        "8iyUDeNX/zE3XqMylgOhEzvC+ZkiOqfyU+5TDeGA5HrVG//FYn9D+8nwkfgT9lz0J1o5pzoqiPJlFO9VULw7lTr7"
        "6q8o9tZi9ORTPY0J695yjLT2cIJbmQ7CqnEcdujs610h4AV6K+rvX+k08HFm1XAdtmx/rNOgo04zuf/Qofc7huu0"
        "dfiWDtmpZup6f1Es4ZHR0wid6hbVBfNIlJOrU+ckQonriWp16S4a173dtNdW4JZc1BvvumvAfO1uvBI4FxtTK/Al"
        "AxmcT8zGd0MHMlPHAKnXdd1wsHgbcEuig4HryRpN6S4L4Ky77BsTTtT9sv7Fy/yDTn0OhHTKGHDJPsMZZEWcUbfF"
        "vQJw+1DE9u7eR75J9z52dO/jKXTvw7R7H7279lENXfvY1LWPKzI6xamadkKqP9c5Z8mwUG6V1Uf5+8/p/g1+TfOJ"
        "EQfC2vS4ptwNjLmVnOPXPb49gGe+Fs+Dr3/mwYwWM3A4WP48F4+/YXm8mWTisyj0bNSLrkgB+/Z4zpHBjHLVlUhr"
        "FoOPXJfdHMjVCo42CuPTBFx8Okx9WC4YkIFubtj5SlVhtCFouECShZI9EW7PQVf5WsCPUIc8ldg6kwkIVjWJ4eo9"
        "N9HY2u2YwO4uVRWtEUNQKw20waxtpr4yjDnmeikcuULRdcwtJ7Tj8bLrxJBM9BQzlah82hCLmcvdlRR5dvZx6bRj"
        "Cy34JDqJW/K6lELOGcKb2iYaaK5W0Qjze0LT1hltRkPISNTx84o4fN39EwhqV2GM3RCZi6/5mC+dQonGnO6PcZ81"
        "veIWNIkgPQwq5sJcBY0uiKdpuy0cPgQH/k6nyF8+MxtgbimUsKQ47vzeLZiean01NFQEv/qSd5Fk3U5m6zHQKOlK"
        "thN611jXRtK6xEwpzGzByHGWksYex1KFtvVs+b3KViQd5vbh01lkyKFZLbXcdt945nf2Oj2w4rR4MKugMfbmYmTy"
        "bvOC8W0jmCuusDiZJWKueIWtMoIew3wJLG+yBvd2H+yYkwhXT7JgThuntGWjHifLe3o0uBCfcGFVMYuJhJcfsPRn"
        "s4pFhTPJAkoGPj/B8RQbM55WFituJhGsK+HcmcavQ3OajtzTP+UXlph0Zax89splslxWy2e4XLbLZ74DWBbMZcSw"
        "NioP3TW8xrSMH8LUNrR75uqNVDfnZIW46+8nwI5F4IwJiVMO7KZZTtKkcWxnyX1WCWFrOJjse/r8NmZnR+5Yyw6V"
        "Y0rmBTCNWILBkuNX84idNDvtPadFRO5F3sF7nchdyTKRaxZGvx+VtWSHk2Gv1EjAbVX5agGCrBF6MzWfIKAhSHwZ"
        "gv4sYcLIsh8DGKfRC3PPr9iU76kXpAlBEFGsyaVnTvDXElUOhorbnoyWBLT5m7dRi9y60ZuwTzmYWXG3qqWWKnZV"
        "CBwqHyqepxkD+tseP7/zPrzqxAhXl7bcW4sg9slo6VTMi83a6SAbifxdltMFEvlYBuYSuVXnIgQ7kfnwk+HSgAoE"
        "hgn1ystLuXGaM3wBdtxxFU9VuZuxo35upzc7Rm1nRvFLteikEW/qUthfPFBvbYMcDHbXKn/ywC3GK0/AEIJW6Yej"
        "ueB9Gcst9NWF8G+KloxV/9vyPyFWojRfmkE2AZy+4yTyqvkSzXxvhaoAk5iXRy3B2c0ZHkgzXHpdLeZUO49G3gNo"
        "o50/se++df+AypOErqXSV0SCIP9RCK58wvbnNmArXd9p6Kf+6pXhluDbYltK40rs6fva0r7sy2PDm6z9SduHjHou"
        "bPfj+Lc2D+X6/bO6X4+snwwG+zK1lT8J/1V9d9icx+oMGiim9On9Y9XNPqbJjzEWC6DKYAXKyg0zV66we0GzPX7R"
        "KeGem0kyVULoaykBJFsqNAX0UtpZORKNbi6YttJDEl8AI7lPGloDDszX6nc18cx4kiVbnrQWLvn/WfqrIq7/l6W+"
        "/DLwJwtrluF5Hoxaep/WOP6x0cFihTLJAZy0gcYpP8IYNFr3YBBfaTlKfapg4rcdsTAO54/UGvlp/UQ7GkWwTKG6"
        "58t/JKdDzEH7/ublVj2eeAvAOLNt1cv0xugUIn+f6hdDbV+aXON2zTQHZWNLsXF6cfPNKCLP3E8FVxXxaQOakU+b"
        "hZkGo4G9GBCeSQRRDWK/ZoMJVZhBiipn7d9BxbD1+zp2mboR+oUx9xheBJ3ZFG3CSBamPdJagi0Z6oEJZtzGvCAI"
        "KxeAIgoeeH+9H059g3FGkqVKb0qJsA4duVfL/B/BpH12PR2/pgCjmdRHR+jYB+mXsC/IdOrY8/VAmPYP6FUaAxFl"
        "GHJ5a6Y0UTHCTu1WppfDmqOUBNZ6PsdjY1c/Dz6t7SO4il5VeOvCeRZvl2ya2omebyhxFlehN91+A69h9KeP0f8O"
        "0MqHK2nsemf5zn3sq8id0uHcFxfuuxFksfxKEFbJIhlN1hBdEMFiCKun8Vj+kIbii6hCF/tWM3pH/XzaJ4GFD6SV"
        "BbYGF5rMMdAf8TtVRitlMEBNvyFuUMp+1+pLcDEGPyjN8WT8aUbc9fOp2wWwlJi/cPUMot9BN6twx9NeqF9CzL0b"
        "9oDezZqEd1a3G4+sG91/f2ks/Bt1sLsG"
        ,
        [
            (32, 0, 0, 0, 0, 3, 0, 15, 3, 15), (33, 0, 5, 3, 10, 3, 0, 5, 3, 15), (34, 1, 4, 5, 4, 6, 0, 4, 6, 15), (35, 1, 5, 7, 10, 9, 0, 5, 9, 15),
            (36, 1, 3, 8, 13, 9, 0, 3, 9, 16), (37, 0, 5, 12, 10, 12, 0, 5, 12, 15), (38, 0, 5, 10, 10, 10, 0, 5, 10, 15), (39, 0, 4, 3, 4, 3, 0, 4, 3, 15),
            (40, 1, 3, 4, 13, 5, 0, 3, 5, 16), (41, 0, 3, 4, 13, 5, -1, 3, 5, 16), (42, 1, 8, 7, 6, 9, 0, 8, 9, 15), (43, 0, 7, 8, 7, 9, 0, 7, 9, 15),
            (44, -1, 14, 3, 3, 3, -1, 14, 3, 17), (45, 0, 10, 4, 1, 4, 0, 10, 4, 15), (46, 0, 13, 3, 2, 3, 0, 13, 3, 15), (47, -1, 4, 6, 11, 5, -1, 4, 5, 15),
            (48, 0, 5, 9, 10, 9, 0, 5, 9, 15), (49, 1, 5, 6, 10, 9, 0, 5, 9, 15), (50, 1, 5, 8, 10, 9, 0, 5, 9, 15), (51, 1, 5, 8, 10, 9, 0, 5, 9, 15),
            (52, 1, 5, 8, 10, 9, 0, 5, 9, 15), (53, 0, 5, 9, 10, 9, 0, 5, 9, 15), (54, 0, 5, 9, 10, 9, 0, 5, 9, 15), (55, 1, 5, 7, 10, 9, 0, 5, 9, 15),
            (56, 0, 5, 9, 10, 9, 0, 5, 9, 15), (57, 0, 5, 9, 10, 9, 0, 5, 9, 15), (58, 0, 7, 3, 8, 3, 0, 7, 3, 15), (59, -1, 7, 4, 10, 3, -1, 7, 3, 17),
            (60, 2, 7, 6, 8, 9, 0, 7, 9, 15), (61, 1, 8, 7, 4, 9, 0, 8, 9, 15), (62, 1, 7, 6, 8, 9, 0, 7, 9, 15), (63, 0, 5, 8, 10, 8, 0, 5, 8, 15),
            (64, 0, 6, 13, 11, 13, 0, 6, 13, 17), (65, 0, 5, 10, 10, 10, 0, 5, 10, 15), (66, 1, 5, 9, 10, 10, 0, 5, 10, 15), (67, 0, 5, 10, 10, 10, 0, 5, 10, 15),
            (68, 1, 5, 10, 10, 11, 0, 5, 11, 15), (69, 1, 5, 8, 10, 9, 0, 5, 9, 15), (70, 1, 5, 8, 10, 9, 0, 5, 9, 15), (71, 0, 5, 11, 10, 11, 0, 5, 11, 15),
            (72, 1, 5, 10, 10, 11, 0, 5, 11, 15), (73, 1, 5, 3, 10, 4, 0, 5, 4, 15), (74, 0, 5, 8, 10, 8, 0, 5, 8, 15), (75, 1, 5, 9, 10, 9, 0, 5, 10, 15),
            (76, 1, 5, 8, 10, 9, 0, 5, 9, 15), (77, 1, 5, 12, 10, 13, 0, 5, 13, 15), (78, 1, 5, 10, 10, 11, 0, 5, 11, 15), (79, 0, 5, 11, 10, 11, 0, 5, 11, 15),
            (80, 1, 5, 9, 10, 10, 0, 5, 10, 15), (81, 0, 5, 11, 11, 11, 0, 5, 11, 16), (82, 1, 5, 9, 10, 10, 0, 5, 10, 15), (83, 1, 5, 9, 10, 10, 0, 5, 10, 15),
            (84, 1, 5, 9, 10, 10, 0, 5, 10, 15), (85, 1, 5, 9, 10, 10, 0, 5, 10, 15), (86, 0, 5, 10, 10, 9, 0, 5, 10, 15), (87, 0, 5, 15, 10, 14, 0, 5, 15, 15),
            (88, 0, 5, 10, 10, 9, 0, 5, 10, 15), (89, 0, 5, 9, 10, 9, 0, 5, 9, 15), (90, 1, 5, 8, 10, 10, 0, 5, 10, 15), (91, 1, 3, 4, 13, 5, 0, 3, 5, 16),
            (92, -1, 4, 6, 11, 5, -1, 4, 5, 15), (93, 0, 3, 4, 13, 5, 0, 3, 5, 16), (94, 1, 6, 7, 6, 9, 0, 6, 9, 15), (95, 0, 15, 7, 1, 8, 0, 15, 8, 16),
            (96, 0, 4, 3, 2, 5, 0, 4, 5, 15), (97, 0, 7, 8, 8, 8, 0, 7, 8, 15), (98, 0, 4, 9, 11, 9, 0, 4, 9, 15), (99, 0, 7, 8, 8, 8, 0, 7, 8, 15),
            (100, 0, 4, 9, 11, 9, 0, 4, 9, 15), (101, 0, 7, 8, 8, 8, 0, 7, 8, 15), (102, -1, 4, 5, 11, 4, -1, 4, 4, 15), (103, 0, 7, 9, 11, 9, 0, 7, 9, 18),
            (104, 0, 4, 8, 11, 8, 0, 4, 8, 15), (105, 0, 4, 3, 11, 3, 0, 4, 3, 15), (106, -1, 4, 4, 14, 3, -1, 4, 3, 18), (107, 0, 4, 8, 11, 8, 0, 4, 8, 15),
            (108, 0, 4, 4, 11, 3, 0, 4, 4, 15), (109, 0, 7, 13, 8, 13, 0, 7, 13, 15), (110, 0, 7, 8, 8, 8, 0, 7, 8, 15), (111, 0, 7, 9, 8, 9, 0, 7, 9, 15),
            (112, 0, 7, 9, 11, 9, 0, 7, 9, 18), (113, 0, 7, 9, 11, 9, 0, 7, 9, 18), (114, 0, 7, 5, 8, 5, 0, 7, 5, 15), (115, 0, 7, 7, 8, 7, 0, 7, 7, 15),
            (116, 0, 5, 5, 10, 5, 0, 5, 5, 15), (117, 0, 7, 8, 8, 8, 0, 7, 8, 15), (118, 0, 7, 8, 8, 8, 0, 7, 8, 15), (119, 0, 7, 12, 8, 12, 0, 7, 12, 15),
            (120, -1, 7, 8, 8, 7, -1, 7, 8, 15), (121, 0, 7, 8, 11, 8, 0, 7, 8, 18), (122, 1, 7, 6, 8, 8, 0, 7, 8, 15), (123, 0, 3, 5, 13, 5, 0, 3, 5, 16),
            (124, 1, 3, 3, 15, 5, 0, 3, 5, 18), (125, 0, 3, 4, 13, 5, 0, 3, 5, 16), (126, 0, 10, 8, 2, 8, 0, 10, 8, 15),
        ],
    ),
    16: (
        "eNqtWAdcVMfWP5QFFkSsiBGpSxFRwC4a8UVjS/IkmthrjCESWyyAlUVAUUGNERMiFiBGsYsIYhexE8GGoIL0tgtL"
        "ucuyC7vnm5m7iCbqM78vF3bOuTNzp5w55X9GjOI3/oTC58/T0v5SKQbQL9PfNRkABp6DR10J9V/V6SnA3Jqmek5Z"
        "4wBQ1CZ4Aam2zYBLbgBPGpo5DXcIrHevHflQZAGQOOiraNIMhcKNvoR0eQzJg4A9YmRkSiZGugAsVdzEY/VO8PI3"
        "Uv8kFho2ETrBF/7M3Mz6/adejSGdCGOZjFUlPdj3XYpThojbk37b6qajN6FRBWbSrIM4jVsLA+6osGiVbus8MJxs"
        "BoY9UGQOBfBusIWXKb0v5IFpkT9AxWGT+Ar46aE+WU6tpmZSvya2RkE3fb37u0H7LCs103JW3NehlZUbKJtwdiyO"
        "Jv8AEzlrPzQwxJXQtmQFjMVZc0jtrkwyZKhEEgzQ73ipsswTwE35R5/urm0B/JCON9wG+qp8SS8q68HFao5DFedU"
        "lODtLMKdonM36CSkiduiZSpOa5lwDHaz6k8YPZ8bFU01j6fCqzMzzraHiDjoIB8BC2v04NRlgJe/AsjDyG8Tz9M6"
        "2kb70L5g8lQU8w2AQ00XgDSy3BVlAF7YC7riLDDCFexHeS90ZW2kD+174BsmkXx4RdaeGlkw8tRa/SG/4p6h+mBw"
        "bcZ1A4DIjbApEqC/ERj1124A3klzmBC42TYiKgNR27/1O5gvkAV9qrHbdRX8OO5Je5HI2hTyZqT/lzZ6ptIyfCkt"
        "X1iRwj2dshtW0fKxEykcH1N2VTAt77nTA82l7NJwWqaSMwLdVTqU751Sz6X0BktZUu9eSdWWEbVkKW1rIx6cpI0n"
        "M+u2spnq1EwVNjS3vLe0t/S3lJ11dT0rswS38xx3nliJ3QmlWKy4iuKSaWRHptpt/c/C8Xh57bVBYF52yNX9Up1V"
        "QIUhsTtc4EO3aoY/8FqqtGLmoqTWBh9zIeyNC6Pk04ZASsYowi3I06YR2SMGh/gyefrn0KH0qJvDjia30beN6Xg/"
        "0r5mO/BLQlYjxlJb6uC5bpEOfxJJW86spnRr9Z5HeoReLunReGSw+05cCJ5XqquujGO9hI9569ujZnRy7R5K7Wpn"
        "U6sU3I1l1hmR3YbScQ1uzFolxAg4FXIi+uxE0evegtFP+YW3AZ8cuhELHQg7pTXNI1EHywt/aw+Q3rDabbqEaHnq"
        "GjovevHtHXFR2xDitaAdLtepokY1EQfDBqWvy5Tyo8TZBeQ0FgQKAIyCCxXZK3V0ki4OsZ2vCJwmFZKus/0SYxc+"
        "kaaOgpKs00M+jlePUuYQy9XNvqHcRQffpcjfQemO2tinpF4/66yr4oh7n2Nyd/C8KufOeQC/cGxgy7arCmVrWieh"
        "Gg7mdUvY6+48A0ocm6ay1xPpTOCe+Al7vZHMyAR1b0r0c2L4fX12o0Z2yRMGNUf3cN7DiZYjUaq2uMhVvsrAYA3O"
        "hC+UajUmGQyTh/QZe3cy3KejDFK7KTfTM8IVL88Q6oELVuAqB8/0aguYfZ8rPehINOcKJ7/qCePUUW69ohSu96/S"
        "ya7HKJk72vqyOIHSM0qxxtdYuFTSqLdapmmK3Vns0g26CCEx4SK1xU7ySd4YKhqQdkYHJmcqCoINIf2L3OnG2iNr"
        "sdz0LwBypwO01L/2mCptYdILgN8jQa9qvLayPS28rhEl9LyYNV23f/KjyURFkbfcxUVxTkz/VpQfpMEC2qyWzGOf"
        "mbmd5NjTlemXSDvam5Xt+coqMXP5jrGVa9pQxn5fqR9bnn0OsSS96U9POurNzDnbB+D5BRYxhvHf6Xz/SJ4fYbKy"
        "ycd+fM3+vFiqE7K+HxESm03b3ZXTSGlRSFUTLjFD+yiV/9KUkVkvGPG+y49nHpQuKTzKZphWf+Grnp8cVn8HMEO9"
        "gLWGNXmY1281CC/JWbxPUPp7kLx9VJX3+IZUiClKT3JoJh66ZDNsVMm2z8UuYNjkDbuqVaEr0QDGoQWkJxbvH4Pj"
        "rR80d1qiGhhfpB9RlTHmnvzWx/AxCWX00aVRN1AT0R1MvW+zGSdmolJ1foRWcu26G746qCu4XMtZqs+la1n/rIHo"
        "wLOP1uoUrWecO9rDzizGht+hocaNTlWiaW5uRuqsPsXhrq6ucTSixNxm4ZvYqXE9k5VuyU6YprFkH+8o1yMGpak5"
        "PxKQuDWXn5t7M3fZBpdRKgzAaTSWaPCIgMaSAeuDjfgYcvYPnobV8fR4Pv3edqU6gFpo45/zSd24CzLu4Vpy4mub"
        "gl1FMwqv6A3TMDfrqp55IlefLeAXv4q4lu03hbVw0ld1ybl6vB37eqMP88I4DqKVa52dvpMSj6Mz/55c8WCZPnUN"
        "GtllYvNkGR+5h6oOaGPdZJyuDX4PrmqZPTItE6bSMjGlPKObe4xnvtcMI+N07ROuXs+PfJ74Y6338Ubm/y0M3xmE"
        "VdQU7gIVmEjU/e/t/Pcm2vEC/tm4cdpxLd4PAni3drGGe7KhHTkAhb9jj0XcPeNhmtm0YQ5+c+IZjUhg+O3Qipg3"
        "DmAXmWR1FTW6ziIPFJ9/zvoNRPEknEO5Q2T8eIWfg8vu3wmnv+xxo/Q3Ux7ssgDzQQzbColS/F5ImPqwz9/293p8"
        "+yBS6c/Iy/10MyVBDVNsZzWFC9blNjxbb8APJ67uxZgl3GAmzTmNo5hYJyi/ZvId2fgtE3QSx0cX1ESqWTDCSAjA"
        "GdozONzoyTPGGRXW/KnYSB6a/q9j+2C6y5k+HVrViDefdeRF+oyxGRUEeBAUSibW7CXie0ABzLJ0KsnAB4RNC6Cs"
        "C/ElXdQOTNBPVoJPJi9z8S1IWcOzLpqeKiftSTy58bDlUAJxPWPRj18XFlea8MwmguEZI15cYcwzRqXLeAaWlgl5"
        "Rli2hGfgx1IjnhGWL9Ke6fJiLWNcQclXl2WNL34iGRFsV4p7WX92p8SBOGCmkEbZt+BsNtNSmIZ9JbG8fOzRt8Wh"
        "CHFNa+2CRG3f6dhnLM5lI+TcpOMGulqNu1NKQ9qkKzXKvJ0WvM0r7i/To7ZpM0cexgs/qoynOySMDpH8QhVaVb/b"
        "mOizfXd9+ADbZBva0aV1Q8V2rRtKfW1Dbq1L92nd0Oq3bsjt1YZSXm0oy5zfEN3KNW0gAb2eazvTCuXTUCFzSHY+"
        "DXu0q/utSsv8XMYYnf/U/MCcjxIJVKYW655Y1Y7vY4mTtJ3L1muZK4e0TFClEej6PpAXRBI8EFH9le3YvCu6ULud"
        "OibsD8UpNEd0bUecbZpvd7aqAfsq8JobH8mH3pdZWnnRjTnignFIcxNzXChIlc62G3SxwhzMQrIbimNsWrwyIvWd"
        "zIW+Ied/g9G+vXI2/4wJ5NGeCa5Ky9BliPmTUepD/exnSS7pgdf5cnnWBlPwRhfeO1UbGNbwIT4rCmD/Q5ZHIcm5"
        "RyPBkxD6kjgc/UqKfJ6z3GR3BkBfdGboidjxlnu89Ehans/jYYhIH9RkzrP98VRSi/49RwqiYDlSXDUKGbAK4Azc"
        "yIECbK5h1ecSQafyZ8Kkb2gg0FK/fiHxamTC9ur+F6IJAqa45Fu1GUyQ6gbkEaRC80AbHAu748lU1pAcSQfNDYWc"
        "eaArm6tfxxLMqFRLJMd9MnagkqHCrxXfPSVkYZH/ZT7H0Dz7iZAemO3Pr/Q+fkZJCcM4HcroesCpYQWMVxOx6N26"
        "SCQSl2ME/lXdKKwtDXNpnMC++7wpJ1q72cfoxDM+0luXmLE4yqfY1FG/JUgnMGKuqi+BAxWdKdDIMfFSswE6lUfv"
        "rWxHuUWN9uY1NDdpX7WROKsmclY/FZvQFOUCODUxOY7EL8/yGBROVKvdec4GD8BfNeo93OuabOFWe4xPFHNYerNQ"
        "Tt04uDTMpMQg41ce+91j4PETqQ2D9IV81nj0FzaCRct4JNL2IGbLgtsH/1RcDxKYDXSLO7FDY+h/9Fl2r1POVhTL"
        "EixvtkphBU3w4Jg3Lacyz2RaLmA4cTQt50XRssMPcQRaWIj+0TrEcRyKLUSiDkTc65j7mvx8HyU3PZ+T8+qXAWJi"
        "DXHfg2WhwKKK4P+EqUF7qIu57cHnJB6GfFJiaF7RGybGw6hb9ZL4LuChCrEbWnAK/KjFbKkjhfW46ac0YJtWl3KY"
        "pN1pTzoChCAoImiKhnAjd4goQIqm9ufqq08sQ+t3evig4CLFvRGAeQn9+iaqXLGA5KNGknhkunggH9ltR5gSmXHs"
        "L8ZsfRrjDmDtUfd+KTI73HK0uj6BqKvj6XrJURuwrTrp0Tf1RdvYQgOaFswto5uDrmbNG7VJ1l7thUIRkbdI8ZmX"
        "Or7XoHt/CmDM3cbSaK3hv5H/a6nz6bqqo5vRXpbcz+NELcaSqAyCHCxhwt2Nqk2UBmMBe9+LR+h1iUE+uqoS+vQ9"
        "mYswMr2xKCgIoUciJztgBrbVR3p7Zp6CmBcC6mh68XZaN6dJSQ9Bs7pqLzuFdmeukGrRi36eTSGOnnfT9WDE7cbS"
        "KKJkwnl+EF/zO9RvZcJkhkD8+Xu1w+l0XfXJkP/nHsIaIxgCvpThrVnr2DMcp8C0u7XV18e0Ov43SOiOMtnhDlhw"
        "qOfnXCwWkeOLljBD36DG0FbE+g5y2CtzIsBbYOxhL6At/Obf/q+L66YSEHCn4/vgRdfCJAGhbe6nGZN3/aTMdrQ+"
        "6jmFGpiP7NoOK7apxzNlhYOcO/tOmF7Iy9qy/K7w3Uug/+po4TFVKIYncyU/dDzPFc0HlC0RReMtUmj6IMm6u/LF"
        "ctxFrJYv1rOZ+UL8+r3cB/FamefHu46ti8ViAZN5zIfKHByPVTU+WawDVtI7w539VFtgn4xeTQSqbUqZs7LD+Ty0"
        "MsI1fI09zt/L+oibbaykt4c7ryRfgdPxamXWEp1/zcjfCQ//LeN8h/FjSAJniBX73AHvk/CJ2993dQq2SXWl2wSQ"
        "+qezd+N64IhDXBcOybWLO9KYE1mrjKOMcHZtosvV/gR21gvybrq5P0wF56Ta6uPdW4z13QYdBMAl28MGufx9h8jI"
        "RtTQ447BGnJKeoX4h2Jij5gC7HC4piJyI2aw2/31UsFyBb0IytwNH6mn0EtekohdJIFqRR7NfeXGcJOqYduGiV01"
        "DDnFH/Llb1v+W3edXZGAQNpMcWTWOVIk4ggKQr/cLDcgMKaSfPp9Y5uh+DF41IdcBziSDHrSQFhybrhSqFPpSwLj"
        "NTgRYKgY0RutCLpRmkgGw9XgpZl0RtWPnADE1xOYEV4oOw8wXFk7gN24IYliRo3lNJ+MLyar91G6QmfJduhURW/e"
        "pza777/DbkJOvWhga4YheJLHeldvNg9lQ1Sb7yM4COw5H+goDSMNtwnUmdfc7xK7BwusFc5EihMeRYNJPcnPnCms"
        "3E/a1r1gF0Q28HAdHe/lCkeNNQPwd9fwkMxeUziLV53r9SY8k8IiOnRfztkxpvnpSGjFMAR8WBdQfB8s7QrQS0Xw"
        "lO4dmm8vzSNbs64dQsHlL60YBb59JobaxM6v60VbXAWHip3g+oVOYEYvxl7XGQWJgtvURIym7cXD334v0PpnKEnu"
        "DDpj2ZX8X3RbtY3mOeXDAL55SRwit+1vXbqhPxg2k3XodCPyX1l6yd/9RHH5Tt0vr0sD/g94/1aW"
        ,
        [
            (32, 0, 0, 0, 0, 3, 0, 16, 3, 16), (33, 1, 5, 2, 11, 4, 0, 5, 4, 16), (34, 1, 4, 4, 4, 5, 0, 4, 5, 16), (35, 1, 5, 8, 11, 9, 0, 5, 9, 16),
            (36, 0, 3, 8, 15, 9, 0, 3, 9, 18), (37, 1, 5, 11, 11, 12, 0, 5, 12, 16), (38, 1, 5, 9, 11, 11, 0, 5, 11, 16), (39, 1, 4, 2, 4, 3, 0, 4, 3, 16),
            (40, 2, 3, 4, 14, 6, 0, 3, 6, 17), (41, 0, 3, 4, 14, 5, 0, 3, 5, 17), (42, 1, 8, 7, 7, 9, 0, 8, 9, 16), (43, 1, 7, 8, 8, 10, 0, 7, 10, 16),
            (44, -1, 14, 3, 4, 4, -1, 14, 4, 18), (45, 0, 11, 4, 2, 4, 0, 11, 4, 16), (46, 1, 13, 2, 3, 3, 0, 13, 3, 16), (47, -1, 4, 6, 13, 5, -1, 4, 5, 17),
            (48, 1, 5, 8, 11, 9, 0, 5, 9, 16), (49, 2, 5, 5, 11, 9, 0, 5, 9, 16), (50, 1, 5, 8, 11, 9, 0, 5, 9, 16), (51, 1, 5, 8, 11, 9, 0, 5, 9, 16),
            (52, 1, 5, 8, 11, 9, 0, 5, 9, 16), (53, 0, 5, 9, 11, 9, 0, 5, 9, 16), (54, 1, 5, 8, 11, 9, 0, 5, 9, 16), (55, 1, 5, 8, 11, 9, 0, 5, 9, 16),
            (56, 1, 5, 8, 11, 9, 0, 5, 9, 16), (57, 1, 5, 8, 11, 9, 0, 5, 9, 16), (58, 1, 7, 2, 9, 3, 0, 7, 3, 16), (59, -1, 7, 4, 11, 3, -1, 7, 3, 18),
            (60, 2, 7, 7, 9, 10, 0, 7, 10, 16), (61, 1, 9, 7, 5, 9, 0, 9, 9, 16), (62, 1, 7, 7, 9, 9, 0, 7, 9, 16), (63, 1, 5, 7, 11, 9, 0, 5, 9, 16),
            (64, 1, 5, 12, 14, 14, 0, 5, 14, 19), (65, 0, 5, 11, 11, 10, 0, 5, 11, 16), (66, 2, 5, 8, 11, 11, 0, 5, 11, 16), (67, 1, 5, 10, 11, 11, 0, 5, 11, 16),
            (68, 2, 5, 9, 11, 12, 0, 5, 12, 16), (69, 2, 5, 8, 11, 10, 0, 5, 10, 16), (70, 2, 5, 8, 11, 10, 0, 5, 10, 16), (71, 1, 5, 10, 11, 12, 0, 5, 12, 16),
            (72, 2, 5, 9, 11, 12, 0, 5, 12, 16), (73, 2, 5, 2, 11, 5, 0, 5, 5, 16), (74, 1, 5, 7, 11, 9, 0, 5, 9, 16), (75, 2, 5, 9, 11, 10, 0, 5, 11, 16),
            (76, 2, 5, 8, 11, 10, 0, 5, 10, 16), (77, 2, 5, 11, 11, 14, 0, 5, 14, 16), (78, 2, 5, 9, 11, 12, 0, 5, 12, 16), (79, 1, 5, 11, 11, 12, 0, 5, 12, 16),
            (80, 2, 5, 8, 11, 11, 0, 5, 11, 16), (81, 1, 5, 11, 12, 12, 0, 5, 12, 17), (82, 2, 5, 9, 11, 11, 0, 5, 11, 16), (83, 0, 5, 9, 11, 9, 0, 5, 9, 16),
            (84, 1, 5, 9, 11, 10, 0, 5, 10, 16), (85, 1, 5, 9, 11, 11, 0, 5, 11, 16), (86, 0, 5, 11, 11, 10, 0, 5, 11, 16), (87, 0, 5, 16, 11, 15, 0, 5, 16, 16),
            (88, 0, 5, 10, 11, 10, 0, 5, 10, 16), (89, 0, 5, 10, 11, 9, 0, 5, 10, 16), (90, 1, 5, 8, 11, 10, 0, 5, 10, 16), (91, 2, 3, 4, 15, 6, 0, 3, 6, 18),
            (92, -1, 4, 6, 13, 5, -1, 4, 5, 17), (93, 0, 3, 4, 15, 5, 0, 3, 5, 18), (94, 1, 5, 7, 7, 9, 0, 5, 9, 16), (95, 0, 16, 8, 2, 8, 0, 16, 8, 18),
            (96, 0, 4, 3, 2, 5, 0, 4, 5, 16), (97, 1, 7, 8, 9, 9, 0, 7, 9, 16), (98, 1, 4, 8, 12, 10, 0, 4, 10, 16), (99, 1, 7, 8, 9, 9, 0, 7, 9, 16),
            (100, 1, 4, 8, 12, 10, 0, 4, 10, 16), (101, 1, 7, 8, 9, 9, 0, 7, 9, 16), (102, 1, 3, 4, 13, 6, 0, 3, 6, 16), (103, 1, 7, 8, 12, 10, 0, 7, 10, 19),
            (104, 1, 4, 7, 12, 9, 0, 4, 9, 16), (105, 1, 4, 2, 12, 4, 0, 4, 4, 16), (106, 0, 4, 3, 15, 4, 0, 4, 4, 19), (107, 1, 4, 8, 12, 8, 0, 4, 9, 16),
            (108, 1, 4, 3, 12, 4, 0, 4, 4, 16), (109, 1, 7, 12, 9, 14, 0, 7, 14, 16), (110, 1, 7, 7, 9, 9, 0, 7, 9, 16), (111, 1, 7, 9, 9, 10, 0, 7, 10, 16),
            (112, 1, 7, 8, 12, 10, 0, 7, 10, 19), (113, 1, 7, 8, 12, 10, 0, 7, 10, 19), (114, 1, 7, 5, 9, 5, 0, 7, 6, 16), (115, 0, 7, 7, 9, 8, 0, 7, 8, 16),
            (116, 1, 5, 4, 11, 6, 0, 5, 6, 16), (117, 1, 7, 7, 9, 9, 0, 7, 9, 16), (118, 0, 7, 9, 9, 8, 0, 7, 9, 16), (119, 0, 7, 13, 9, 13, 0, 7, 13, 16),
            (120, -1, 7, 9, 9, 8, -1, 7, 8, 16), (121, 0, 7, 9, 12, 8, 0, 7, 9, 19), (122, 1, 7, 6, 9, 8, 0, 7, 8, 16), (123, 1, 3, 4, 15, 5, 0, 3, 5, 18),
            (124, 2, 2, 2, 17, 5, 0, 2, 5, 19), (125, 0, 3, 5, 15, 6, 0, 3, 6, 18), (126, 1, 10, 7, 2, 9, 0, 10, 9, 16),
        ],
    ),
}
